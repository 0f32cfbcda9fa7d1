"""Training configuration, port of pasta_tpu/train/config.py.

The shipped `fashion` preset: 512px, total batch 32 (4 per device over 8
devices in the reference run), lr 5e-4, Adam(0, 0.99), R1 gamma 10, mbstd
4, EMA 10 kimg, 1 mapping layer, ADA 'bgc' targeting 0.6; loss weights
from train.sh: l1 10, vgg 20, mask 30.

Not ported, because they are memory or compilation workarounds of the TPU
program: `step_mode`, `bwd_chunk`, `donate`, `remat`, `remat_min_res`,
`spade_inner_remat`, `d_remat`, `vgg_remat`. `ada_impl` has one value in
the port (the two-pass warp with K2/K3) and is not a field. The options
of the next slice -- `grad_accum`, `reuse_g_fakes`, `pl_weight` (Gpl),
`double_d_parsing`, `freeze_d_layers`, `contextual_weight`,
`strict_phase_noise=False` and more than one GPU (`data_axis_size`) --
raise if set to anything but their default. The path-length regularizer's
`g_reg_interval`, `pl_batch_shrink` and `pl_decay` come with Gpl,
`metric_items` with the in-training evaluator; `ada_interval` is unused in
the JAX package too, and `style_mixing_prob` is a field there with no
effect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# option -> the only value the port takes yet
_DEFERRED = dict(grad_accum=1, reuse_g_fakes=False, pl_weight=0.0,
                 double_d_parsing=False, freeze_d_layers=0,
                 contextual_weight=0.0, strict_phase_noise=True,
                 data_axis_size=1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model
    resolution: int = 512
    channel_base: int = 32768
    channel_max: int = 512
    conv_clamp: float = 256.0
    mapping_layers: int = 1
    use_noise: bool = True
    z_dim: int = 0
    c_dim: int = 512
    w_dim: int = 512

    # optimization
    batch_size: int = 32
    data_axis_size: int = 1          # number of GPUs (one, so far)
    grad_accum: int = 1
    # Lazy R1 on batch // r1_batch_shrink samples (an unbiased estimate of
    # the same penalty).
    r1_batch_shrink: int = 1
    # Every D / parsing-D phase takes a fresh no-grad generator draw.
    strict_phase_noise: bool = True
    reuse_g_fakes: bool = False
    mbstd_group_size: int = 4
    lr: float = 5e-4
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    total_kimg: int = 10000

    # objectives
    r1_gamma: float = 10.0
    l1_weight: float = 10.0
    vgg_weight: float = 20.0
    mask_weight: float = 30.0
    pl_weight: float = 0.0
    contextual_weight: float = 0.0
    sanitize_grads: bool = True     # nan_to_num on grads
    d_reg_interval: int = 16
    double_d_parsing: bool = False
    freeze_d_layers: int = 0

    # EMA
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None

    # ADA
    ada_target: float = 0.6
    ada_kimg: float = 500.0
    augment_p_init: float = 0.0
    use_ada: bool = True

    # Training data loader ('host' | 'device'): 'device' keeps only decode
    # and scalar geometry on the host and runs the per-sample warps and
    # rasters on the card (data/trainsets.py::assemble_train_batch_lean).
    loader_impl: str = "host"

    # Mixed precision: the D's top resolutions in bf16 (the reference's
    # fp16 blocks), the G in fp32 unless g_num_bf16_res > 0, the VGG19
    # input in bf16.
    d_num_bf16_res: int = 3
    g_num_bf16_res: int = 0
    vgg_bf16: bool = True

    def __post_init__(self):
        for name, value in _DEFERRED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (only {value!r})")
        if self.loader_impl not in ("host", "device"):
            raise ValueError(f"loader_impl {self.loader_impl!r}: "
                             "'host' or 'device'")

    def lazy_reg_scale(self, interval):
        """Lazy-regularization hyperparameter scaling
        (training_loop_fullbody.py:474-481)."""
        mb_ratio = interval / (interval + 1)
        return dict(lr=self.lr * mb_ratio,
                    b1=self.adam_beta1 ** mb_ratio,
                    b2=self.adam_beta2 ** mb_ratio)


def fashion_config(**overrides) -> TrainConfig:
    return TrainConfig(**overrides)


def smoke_config(n_devices=1, **overrides) -> TrainConfig:
    """Tiny config for CPU tests (the JAX package's smoke_config)."""
    defaults = dict(
        resolution=64,
        channel_base=2048,
        channel_max=128,
        batch_size=n_devices * 2,
        data_axis_size=n_devices,
        mbstd_group_size=2,
        vgg_weight=0.0,
        total_kimg=1,
        d_num_bf16_res=0,   # fp32 smoke numerics
    )
    defaults.update(overrides)
    return TrainConfig(**defaults)
