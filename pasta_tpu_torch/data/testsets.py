"""Try-on pair dataset over a test_pairs.txt file layout: the port's copy
of `pasta_tpu/data/testsets.py`, unchanged in behaviour
(tests/test_torch_inference.py holds it equal to the original).

Replaces the reference UvitonDatasetFull_512_test_{full,upper,lower}
classes (dataset.py:1251-3480) with one parameterized iterable.
`to_model_inputs` returns numpy arrays; the caller uploads them.
"""

from __future__ import annotations

import os
from typing import Iterator, Dict

import numpy as np

from .preprocess import load_person, preprocess_pair


class TryonPairDataset:
    """Iterates (person, clothes) pairs listed in `<root>/<pairs_txt>`.

    Each line: `<clothes_image_name> <person_image_name>`
    (dataset.py:1978-1987).
    """

    def __init__(self, root: str, pairs_txt: str, mode: str = "upper",
                 use_sleeve_mask: bool = True):
        from .roots import as_root

        assert mode in ("full", "upper", "lower")
        self.root = as_root(root)
        self.mode = mode
        self.use_sleeve_mask = use_sleeve_mask
        self.pairs = []
        # Prefer the entry inside the root; only treat pairs_txt as an
        # external filesystem path when it is absolute or absent from the
        # root (a same-named file in the CWD must not shadow the dataset's
        # pairs list).
        external = os.path.isabs(pairs_txt) or not self.root.exists(pairs_txt)
        if external and os.path.isfile(pairs_txt):
            with open(pairs_txt, "r") as f:
                text = f.read()
        else:                                   # entry inside the root
            text = self.root.read(pairs_txt).decode()
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            clothes_name, person_name = line.split()
            self.pairs.append((person_name, clothes_name))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        person_name, clothes_name = self.pairs[idx]
        # Sleeve-mask source: person's garment parsing in 'lower' mode,
        # clothes' otherwise (dataset.py test variants).
        person = load_person(
            self.root, person_name,
            with_garment_parsing=(self.use_sleeve_mask and self.mode == "lower"))
        clothes = load_person(
            self.root, clothes_name,
            with_garment_parsing=(self.use_sleeve_mask and self.mode != "lower"))
        return preprocess_pair(person, clothes, self.mode,
                               use_sleeve_mask=self.use_sleeve_mask)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]


def to_model_inputs(batch_items):
    """Stack per-pair dicts into the generator's NHWC input dict + extras.

    Port of the tensor assembly in the reference test.py:124-148:
    [0,255] -> [-1,1], parts = norm ⧺ norm_lower (45ch), retain = masked
    image ⧺ skin (6ch), pose = stick ⧺ label ⧺ bound (5ch).
    """
    def stack(key):
        return np.stack([item[key] for item in batch_items]).astype(np.float32)

    def norm01(x):
        return x / 127.5 - 1.0

    image = norm01(stack("image"))
    pose = norm01(stack("pose"))
    norm_img = norm01(stack("norm_img"))
    norm_img_lower = norm01(stack("norm_img_lower"))
    skin = norm01(stack("skin_average"))
    label = norm01(stack("lower_label_map"))
    bound = norm01(stack("lower_bound"))
    denorm_upper = norm01(stack("denorm_upper_img"))
    denorm_lower = norm01(stack("denorm_lower_img"))
    retain_mask = stack("retain_mask")

    retain = image * retain_mask - (1 - retain_mask)
    n = image.shape[0]
    inputs = dict(
        z=np.zeros((n, 0), np.float32),
        c=np.concatenate([norm_img, norm_img_lower], axis=-1),
        retain=np.concatenate([retain, skin], axis=-1),
        pose=np.concatenate([pose, label, bound], axis=-1),
        denorm_upper_input=denorm_upper,
        denorm_lower_input=denorm_lower,
        denorm_upper_mask=(
            stack("denorm_upper_img").sum(axis=-1, keepdims=True) > 0
        ).astype(np.float32),
        denorm_lower_mask=(
            stack("denorm_lower_img").sum(axis=-1, keepdims=True) > 0
        ).astype(np.float32),
    )
    extras = dict(
        image=image,
        clothes=norm01(stack("clothes")),
        person_names=[item["person_name"] for item in batch_items],
        clothes_names=[item["clothes_name"] for item in batch_items],
    )
    return inputs, extras
