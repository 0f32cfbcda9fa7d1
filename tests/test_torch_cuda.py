"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Needs an NVIDIA GPU with nvcc; skips otherwise. The repo's conftest sets
up jax for the JAX package's tests, which this file does not need, so run
it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pasta_tpu_torch.ops import conv3x3 as k1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (N, H, W', C_in, C_out, out_w): ragged W edges (out_w not a multiple of
# the 128-pixel tile), odd H (blocks of two output rows), C_out below /
# equal to / not a multiple of the 64- or 128-channel tile, and alignment
# columns past out_w + 2.
SHAPES = [
    (2, 5, 20, 64, 64, 18),
    (1, 3, 131, 128, 128, 129),
    (2, 4, 70, 64, 3, 60),
    (1, 6, 67, 128, 100, 65),
    (3, 2, 9, 64, 128, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_matches_plain(cuda, dtype, shape):
    n, h, wp, ci, co, out_w = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, h + 2, wp, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, ci, co) / np.sqrt(9 * ci))
                         .astype(np.float32))
    xd, wd = x.to(cuda, dtype), w.to(cuda, dtype)
    before = k1.conv3x3_valid.launches
    got = k1.conv3x3_valid(xd, wd, out_w=out_w)
    torch.cuda.synchronize()
    assert k1.conv3x3_valid.launches == before + 1
    assert got.shape == (n, h, out_w, co) and got.dtype == dtype
    # reference: the plain version in fp32 on the same (rounded) inputs
    ref = k1.conv3x3_valid_plain(xd.float(), wd.float(), out_w=out_w)
    err = (got.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    # bf16: the kernel's one rounding of an fp32 sum, 2^-8 relative, plus
    # fp32 summation order; fp32: summation order over 9*C_in terms only.
    bound = 2.0 ** -7 * scale if dtype == torch.bfloat16 else 1e-5 * scale
    assert err <= bound, (err, bound)


@pytest.mark.cuda
def test_k1_raises_out_of_scope(cuda):
    x = torch.zeros(1, 6, 6, 32, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w)
    x = torch.zeros(1, 6, 6, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w.new_zeros(3, 3, 64, 64))
    x = torch.zeros(1, 6, 6, 128, device=cuda,
                    dtype=torch.bfloat16)[:, :, :, :64]
    with pytest.raises(ValueError):
        k1.conv3x3_valid(x, w.new_zeros(3, 3, 64, 64))
