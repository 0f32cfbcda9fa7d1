"""Training state and model/optimizer construction, port of
pasta_tpu/train/state.py.

The state is a plain dataclass of the modules (G, the image D, the parsing
D, the G-EMA as a deep copy of G), their Adam optimizers and the scalars;
the train step updates it in place.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..models import Discriminator, Generator
from .config import TrainConfig


@dataclasses.dataclass
class TrainState:
    g: Generator
    d: Discriminator
    dp: Discriminator
    g_ema: Generator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    dp_opt: torch.optim.Optimizer
    step: int = 0
    cur_nimg: int = 0
    # 0-d float32 on the models' device: the step reads and moves it there
    ada_p: torch.Tensor = None


def make_models(cfg: TrainConfig, seed=0):
    """(G, image D with 3 + 3 input channels, parsing D with 7 + 3), each
    drawn from its own seed (training_loop_fullbody.py:405-410)."""
    g = Generator(
        z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
        img_resolution=cfg.resolution, img_channels=3,
        channel_base=cfg.channel_base, channel_max=cfg.channel_max,
        conv_clamp=cfg.conv_clamp, use_noise=cfg.use_noise,
        mapping_layers=cfg.mapping_layers, num_bf16_res=cfg.g_num_bf16_res,
        seed=seed)
    common = dict(c_dim=cfg.c_dim, img_resolution=cfg.resolution,
                  channel_base=cfg.channel_base, channel_max=cfg.channel_max,
                  conv_clamp=cfg.conv_clamp,
                  mbstd_group_size=cfg.mbstd_group_size,
                  num_bf16_res=cfg.d_num_bf16_res)
    d = Discriminator(img_channels=3 + 3, seed=seed + 1, **common)
    dp = Discriminator(img_channels=7 + 3, seed=seed + 2, **common)
    return g, d, dp


def make_optimizers(cfg: TrainConfig, g, d, dp):
    """One Adam per module (eps 1e-8), lazy-reg scaled where the module has
    a regularization phase (training_loop_fullbody.py:466-487): the D and
    the parsing D have R1; the G has none while pl_weight is 0."""
    plain = dict(lr=cfg.lr, b1=cfg.adam_beta1, b2=cfg.adam_beta2)
    d_h = cfg.lazy_reg_scale(cfg.d_reg_interval) if cfg.r1_gamma != 0 \
        else plain

    def adam(module, h):
        return torch.optim.Adam(module.parameters(), lr=h["lr"],
                                betas=(h["b1"], h["b2"]), eps=cfg.adam_eps)

    return adam(g, plain), adam(d, d_h), adam(dp, d_h)


def example_batch(cfg: TrainConfig, rng: np.random.RandomState):
    """Random numpy batch with the training-input schema."""
    n, res = cfg.batch_size, cfg.resolution
    f32 = lambda *s: rng.rand(*s).astype(np.float32) * 2 - 1
    return dict(
        real_img=f32(n, res, res, 3),
        pose=f32(n, res, res, 5),
        style_input=f32(n, res // 4, res // 4, 45),
        retain=f32(n, res, res, 6),
        denorm_upper_input=f32(n, res, res, 3),
        denorm_lower_input=f32(n, res, res, 3),
        denorm_upper_mask=(rng.rand(n, res, res, 1) > 0.5).astype(np.float32),
        denorm_lower_mask=(rng.rand(n, res, res, 1) > 0.5).astype(np.float32),
        gt_parsing=rng.randint(0, 7, (n, res, res, 1)).astype(np.float32),
    )


def batch_to(batch, device):
    """numpy batch -> dict of tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def init_state(cfg: TrainConfig, seed=0, device="cuda") -> TrainState:
    """Models, EMA copy and optimizers on `device`: the card unless the
    caller asks for the CPU, as the parity tests do."""
    g, d, dp = make_models(cfg, seed)
    g, d, dp = g.to(device), d.to(device), dp.to(device)
    g_ema = copy.deepcopy(g).requires_grad_(False)
    g_opt, d_opt, dp_opt = make_optimizers(cfg, g, d, dp)
    return TrainState(g=g, d=d, dp=dp, g_ema=g_ema, g_opt=g_opt, d_opt=d_opt,
                      dp_opt=dp_opt,
                      ada_p=torch.tensor(cfg.augment_p_init,
                                         dtype=torch.float32, device=device))
