"""Directory- or zip-backed dataset roots.

The port's own copy of `pasta_tpu/data/roots.py` (tests/test_torch_roots.py
holds it equal to the original on a root written to disk). `decode_image`
goes through the `native` plugin's libjpeg/libpng decoder where it is
built, through PIL otherwise.

The reference's ImageFolderDataset transparently reads either a directory
tree or a zip archive (training/dataset.py:189-399, `_file_ext` /
`_get_zipfile` / `_open_file`); this is the equivalent for the try-on
layout written by `cli.dataset_tool` (image/ keypoints/ parsing/
[garment_parsing/] + dataset.json).

Zip handles are per-thread (`threading.local`): the training loader reads
samples from a thread pool and `zipfile.ZipFile` is not safe for concurrent
reads through one handle (the reference solves the same problem with
per-worker-process handles, dataset.py:226-231).
"""

from __future__ import annotations

import io
import os
import threading
import zipfile
from typing import List

import numpy as np


class DataRoot:
    """Read-only view over a dataset root (directory or .zip)."""

    def __init__(self, path: str):
        self.path = path
        self.is_zip = (not os.path.isdir(path)) and \
            str(path).lower().endswith(".zip")
        if self.is_zip and not os.path.isfile(path):
            raise FileNotFoundError(path)
        self._tls = threading.local()
        if self.is_zip:
            # Validate once + snapshot the name list from a temporary handle.
            with zipfile.ZipFile(path) as zf:
                self._names = set(n for n in zf.namelist()
                                  if not n.endswith("/"))
        else:
            self._names = None

    # -- internals ----------------------------------------------------------
    def _zf(self) -> zipfile.ZipFile:
        zf = getattr(self._tls, "zf", None)
        if zf is None:
            zf = zipfile.ZipFile(self.path)
            self._tls.zf = zf
        return zf

    # -- API ----------------------------------------------------------------
    def read(self, rel: str) -> bytes:
        if self.is_zip:
            try:
                return self._zf().read(rel)
            except KeyError:
                raise FileNotFoundError(f"{self.path}!{rel}")
        path = os.path.join(self.path, rel)
        with open(path, "rb") as f:
            return f.read()

    def exists(self, rel: str) -> bool:
        if self.is_zip:
            return rel in self._names
        return os.path.isfile(os.path.join(self.path, rel))

    def list(self, subdir: str) -> List[str]:
        """Sorted file names directly under `subdir`."""
        if self.is_zip:
            prefix = subdir.rstrip("/") + "/"
            return sorted(
                n[len(prefix):] for n in self._names
                if n.startswith(prefix) and "/" not in n[len(prefix):])
        d = os.path.join(self.path, subdir)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    def open(self, rel: str) -> io.BytesIO:
        return io.BytesIO(self.read(rel))

    def decode_image(self, rel: str) -> np.ndarray:
        """Decode an image entry to an RGB/gray uint8 array.

        Uses the native libjpeg/libpng plugin when available (PIL-matching
        semantics incl. palette-index planes; decodes with the interpreter
        lock released), PIL otherwise."""
        from .. import native

        data = self.read(rel)
        if native.available():
            try:
                return native.decode_image(data)
            except ValueError:
                pass  # exotic format: PIL
        import PIL.Image

        return np.array(PIL.Image.open(io.BytesIO(data)))

    def decode_cv2(self, rel: str, flags=None) -> np.ndarray:
        """cv2.imread-equivalent decode (BGR, palette-expanded)."""
        import cv2

        buf = np.frombuffer(self.read(rel), np.uint8)
        return cv2.imdecode(
            buf, cv2.IMREAD_COLOR if flags is None else flags)

    def __repr__(self):
        kind = "zip" if self.is_zip else "dir"
        return f"DataRoot({self.path!r}, {kind})"


def as_root(root) -> DataRoot:
    return root if isinstance(root, DataRoot) else DataRoot(root)
