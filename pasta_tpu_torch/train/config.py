"""Training configuration, port of pasta_tpu/train/config.py.

The shipped `fashion` preset: 512px, total batch 32 (4 per device over 8
devices in the reference run), lr 5e-4, Adam(0, 0.99), R1 gamma 10, mbstd
4, EMA 10 kimg, 1 mapping layer, ADA 'bgc' targeting 0.6; loss weights
from train.sh: l1 10, vgg 20, mask 30.

Not ported, because they are memory or compilation workarounds of the TPU
program: `step_mode`, `bwd_chunk`, `donate`, `remat`, `remat_min_res`,
`spade_inner_remat`, `d_remat`, `vgg_remat`. `ada_impl` has one value in
the port (the two-pass warp with K2/K3) and is not a field.

The training options of the JAX package are all here: gradient
accumulation (`grad_accum`), the shared no-grad forward of the D phases
(`strict_phase_noise=False`) and Gmain's own fakes in its place
(`reuse_g_fakes`, which takes effect only with `strict_phase_noise=False`
and `grad_accum == 1`, as in the JAX step), the path-length regularizer
(`pl_weight` with `g_reg_interval`, `pl_batch_shrink`, `pl_decay`), the
reference's doubled parsing-D phase (`double_d_parsing`), freeze-D
(`freeze_d_layers`) and the contextual loss (`contextual_weight`).
`metric_items` sizes the in-training evaluator's held-out pool
(train/loop.py); `ada_interval` is unused in the JAX package too, and
`style_mixing_prob` is a field there with no effect.

More than one GPU: `data_axis_size` ranks, one a card, each with
`batch_per_device` rows of the global `batch_size` (which must divide).
The step's reductions over the batch are global (train/steps.py), as in
the JAX step over a `data` mesh. One choice differs from that step, by
decision: each rank cuts ITS rows into the `grad_accum` microbatches and
takes ITS first rows // `r1_batch_shrink` for R1 and // `pl_batch_shrink`
for Gpl -- the reference's per-GPU `batch_gpu` rounds and shrunk Gpl
batch, which share the work out evenly -- where the JAX step cuts and
takes prefixes of the global batch. So with ranks and `grad_accum` > 1 or
a shrink above 1 a microbatch or prefix holds other samples than the JAX
step's (rank r's first rows, not the global batch's first rows), drawn
from the same distribution; tests/test_torch_dist_options.py holds the
step against the JAX step on a global batch ordered so that the two
selections coincide.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    data_axis_size: int = 1          # number of GPUs (ranks)
    grad_accum: int = 1
    # Lazy R1 on batch // r1_batch_shrink samples (an unbiased estimate of
    # the same penalty).
    r1_batch_shrink: int = 1
    # Every D / parsing-D phase takes a fresh no-grad generator draw; False:
    # one no-grad forward of the updated G feeds them all.
    strict_phase_noise: bool = True
    # D and parsing D take Gmain's own detached fakes (no extra forward);
    # only with strict_phase_noise=False and grad_accum == 1.
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
    # Gpl runs on batch // pl_batch_shrink samples every g_reg_interval
    # steps; pl_mean is an average of path lengths with this decay.
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    contextual_weight: float = 0.0
    sanitize_grads: bool = True     # nan_to_num on grads
    d_reg_interval: int = 16
    g_reg_interval: int = 4
    # The reference registers the parsing-D phases twice: two DPmain
    # updates a step, each on its own draw.
    double_d_parsing: bool = False
    # Freeze the image D's first N layers (fromrgb, conv0, conv1, skip from
    # the top resolution down).
    freeze_d_layers: int = 0

    # EMA
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None

    # In-training metric evaluation sizing: the held-out pool of the
    # FID/KID evaluator (training_loop's default when the CLI does not
    # override it). 512 items make the in-training FID a sized protocol;
    # the held-out reals' detector stats are disk-cached
    # (TrainingEvaluator cache_dir), so the pool costs one extraction.
    metric_items: int = 512

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
        if self.data_axis_size < 1 or self.batch_size % self.data_axis_size:
            raise ValueError(
                f"TrainConfig.batch_size={self.batch_size} does not divide "
                f"into data_axis_size={self.data_axis_size} ranks")
        if self.loader_impl not in ("host", "device"):
            raise ValueError(f"loader_impl {self.loader_impl!r}: "
                             "'host' or 'device'")

    @property
    def batch_per_device(self):
        """Rows of the global batch each rank takes."""
        return self.batch_size // self.data_axis_size

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
