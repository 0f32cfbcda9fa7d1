"""Shape contracts at module boundaries, port of pasta_tpu/shapes.py
(reference torch_utils/misc.py:86-99).

`assert_shape(x, (N, 512, 512, 3))` -- `None` matches any size. A
transposed or mis-stacked input fails at the boundary, by name and
dimension, instead of deep inside a warp or a conv. The messages are the
JAX package's, word for word.
"""

from __future__ import annotations


def assert_shape(tensor, ref_shape, name=None):
    """Raise AssertionError unless tensor.shape matches ref_shape.

    ref_shape entries may be None (any size) or an int. Mirrors the
    reference's misc.assert_shape error style (dimension-indexed message).
    """
    shape = tuple(tensor.shape)
    label = f" for {name}" if name else ""
    if len(shape) != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions{label}: got {len(shape)}, "
            f"expected {len(ref_shape)} (shape {shape} vs {ref_shape})")
    for idx, (size, ref_size) in enumerate(zip(shape, ref_shape)):
        if ref_size is not None and size != ref_size:
            raise AssertionError(
                f"Wrong size{label} for dimension {idx}: got {size}, "
                f"expected {ref_size} (shape {shape} vs {ref_shape})")


def assert_batch_shapes(batch, specs, name="batch"):
    """Check a dict of arrays against {key: ref_shape} specs; keys missing
    from the batch are ignored (mode-dependent inputs)."""
    for key, spec in specs.items():
        if key in batch:
            assert_shape(batch[key], spec, name=f"{name}[{key}]")
