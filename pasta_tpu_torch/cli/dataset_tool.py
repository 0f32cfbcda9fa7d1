"""Dataset packaging tool, port of pasta_tpu/cli/dataset_tool.py (reference
dataset_tool.py:448-598 equivalent); host code (PIL, numpy, zipfile),
copied unchanged in behaviour.

Collects images (+ keypoints/parsing/garment-parsing sidecars) from one or
more source roots -- optionally filtered by txt lists -- validates them, and
writes the canonical training layout consumed by TryonTrainDataset /
TryonPairDataset (data/roots.py reads both forms; `cli.train --data`
takes either):

    dest/
      image/<name>.jpg|png
      keypoints/<name>_keypoints.json
      parsing/<name>.png
      garment_parsing/<name>.png      (optional)
      dataset.json                    (manifest)

`--dest foo.zip` writes the same layout into a zip archive.

    python3 -m pasta_tpu_torch.cli.dataset_tool \
        --source <root>[,<root2>...] \
        [--txts list1.txt,list2.txt] --dest <dir-or-zip> [--max-images N]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile

import numpy as np
import PIL.Image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True,
                   help="comma-separated source roots (image/ keypoints/ "
                        "parsing/ [garment_parsing/] under each)")
    p.add_argument("--txts", default=None,
                   help="comma-separated txt files (one image name per line) "
                        "matching each source root; default = all images")
    p.add_argument("--dest", required=True, help="output directory or .zip")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--require-garment-parsing", action="store_true")
    return p.parse_args(argv)


class _Writer:
    def __init__(self, dest):
        self.is_zip = dest.endswith(".zip")
        self.dest = dest
        if self.is_zip:
            os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
            self.zf = zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED)
        else:
            os.makedirs(dest, exist_ok=True)

    def write(self, rel_path, data: bytes):
        if self.is_zip:
            self.zf.writestr(rel_path, data)
        else:
            path = os.path.join(self.dest, rel_path)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)

    def close(self):
        if self.is_zip:
            self.zf.close()


def _validate_image(path):
    """Check decodability + 512-max-side convention; returns (h, w)."""
    img = np.asarray(PIL.Image.open(path))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: need RGB, got shape {img.shape}")
    h, w = img.shape[:2]
    if max(h, w) != 512:
        raise ValueError(f"{path}: expected max side 512, got {h}x{w}")
    return h, w


def _validate_keypoints(path):
    with open(path) as f:
        data = json.load(f)
    return len(data.get("people", [])) == 1


def main(argv=None):
    args = parse_args(argv)
    roots = args.source.split(",")
    txts = args.txts.split(",") if args.txts else [None] * len(roots)
    assert len(txts) == len(roots), "--txts must match --source count"

    writer = _Writer(args.dest)
    manifest = []
    n_written = n_skipped = 0
    for root, txt in zip(roots, txts):
        if txt is not None:
            with open(txt) as f:
                names = [line.split()[0] for line in f if line.strip()]
        else:
            names = sorted(os.listdir(os.path.join(root, "image")))
        for name in names:
            if args.max_images and n_written >= args.max_images:
                break
            stem = os.path.splitext(name)[0]
            img_path = os.path.join(root, "image", name)
            kpt_path = os.path.join(root, "keypoints",
                                    stem + "_keypoints.json")
            parsing_path = os.path.join(root, "parsing", stem + ".png")
            gp_path = os.path.join(root, "garment_parsing", stem + ".png")
            try:
                _validate_image(img_path)
                if not os.path.isfile(kpt_path) or not _validate_keypoints(kpt_path):
                    raise ValueError("keypoints missing or not 1 person")
                if not os.path.isfile(parsing_path):
                    raise ValueError("parsing missing")
                if args.require_garment_parsing and not os.path.isfile(gp_path):
                    raise ValueError("garment parsing missing")
            except Exception as e:
                n_skipped += 1
                print(f"skip {name}: {e}")
                continue
            for src, rel in [
                (img_path, f"image/{name}"),
                (kpt_path, f"keypoints/{stem}_keypoints.json"),
                (parsing_path, f"parsing/{stem}.png"),
            ] + ([(gp_path, f"garment_parsing/{stem}.png")]
                 if os.path.isfile(gp_path) else []):
                with open(src, "rb") as f:
                    writer.write(rel, f.read())
            manifest.append(dict(name=name, source=root,
                                 has_garment_parsing=os.path.isfile(gp_path)))
            n_written += 1
    writer.write("dataset.json", json.dumps(
        dict(images=manifest, count=n_written)).encode())
    writer.close()
    print(f"wrote {n_written} images ({n_skipped} skipped) -> {args.dest}")


if __name__ == "__main__":
    main()
