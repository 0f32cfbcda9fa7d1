"""Reader of the reference's network-snapshot pickles, port of
pasta_tpu/io/legacy_pkl.py.

The reference checkpoint format embeds module source code in the pickle and
re-executes it on load (torch_utils/persistence.py:35-227). Unpickling it
therefore needs the reference tree importable: its root comes from
$PASTA_REFERENCE_ROOT (by default `reference/` beside this package's
checkout), read at each call. The port's modules use the reference's
state-dict keys and layouts, so an unpickled `G_ema`, `D` or `D_parsing`
module's state dict loads into the port's `Generator` / `Discriminator`
as it is; only the buffers the port recomputes (the FIR resample filters,
`mask_weight`) and the reference's dead learned `const` (networks.py:
2156-2161, which the JAX import drops too) are left out.
"""

from __future__ import annotations

import os
import pickle
import sys

_DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "reference")
_DROPPED_LEAVES = ("resample_filter", "mask_weight", "const")


def reference_root():
    """The reference tree that unpickling imports from."""
    return os.environ.get("PASTA_REFERENCE_ROOT", _DEFAULT_ROOT)


def _prepare_reference_import(root):
    if not os.path.isdir(root):
        raise RuntimeError(
            f"reference repo not found at {root}; set "
            f"PASTA_REFERENCE_ROOT to unpickle legacy snapshots")
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    if torch.version.cuda is None:
        torch.version.cuda = "0.0"  # reference import-time crash workaround


def _unpickle_snapshot(path):
    """Unpickle a reference network snapshot (the persistence format:
    training_loop_fullbody.py:721-736 writes {G, D, D_parsing, G_ema,
    augment_pipe, training_set_kwargs}; each module's class re-executes its
    embedded networks.py source on load, persistence.py:179-227). The
    reference's import reads files relative to its root, so the load runs
    there."""
    root = reference_root()
    _prepare_reference_import(root)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with open(os.path.join(cwd, path), "rb") as f:
            return pickle.load(f)
    finally:
        os.chdir(cwd)


def module_state(module):
    """A reference module's state dict as the port's modules load it:
    float32 CPU tensors, without the recomputed buffers and the dead
    `const`."""
    import torch

    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in module.state_dict().items()
            if k.split(".")[-1] not in _DROPPED_LEAVES}


def load_reference_pickle_generator(path, key="G_ema"):
    """A snapshot's generator ('G_ema' or 'G') as a state dict for the
    port's `Generator` (`load_state_dict(..., strict=True)`)."""
    return module_state(_unpickle_snapshot(path)[key])


def load_reference_pickle_discriminator(path, key="D"):
    """A snapshot's discriminator ('D' or 'D_parsing') as a state dict for
    the port's `Discriminator`."""
    return module_state(_unpickle_snapshot(path)[key])
