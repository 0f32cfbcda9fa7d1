"""The training step: a frozen plain copy of the port's `train/steps.py` on
the path the benchmark's training configuration takes (one process, one
microbatch, a fresh generator draw for every D and parsing-D phase, no
path-length term, no contextual loss, no freeze-D).

One step runs Gmain, Dmain, DPmain, the EMA and the ADA controller, then
on request the lazy R1 phases Dr1 and DPr1; each phase takes its
gradients with torch.autograd.grad with respect to its module's
parameters, sanitizes them where the port does (nan -> 0, +-inf -> +-1e5:
Gmain, Dmain and the R1 phases) and applies them by its module's Adam,
written out here with torch.optim.Adam's formula. Every phase sees the
parameters the phase before it updated, and every random draw comes from
the one torch.Generator, in the port's order.
"""

from __future__ import annotations

import copy
import math

import torch

from ..losses.vgg import VGG19Features
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from .loss_terms import build_loss_cores

# what the copy leaves out: each must hold its value in the configuration
PATH = dict(data_axis_size=1, grad_accum=1, strict_phase_noise=True,
            reuse_g_fakes=False, pl_weight=0.0, contextual_weight=0.0,
            freeze_d_layers=0, double_d_parsing=False, ema_rampup=None)


class Adam:
    """torch.optim.Adam's update, one tensor at a time: exp_avg lerps to
    the gradient by 1 - beta1, exp_avg_sq takes (1 - beta2) g^2, and the
    parameter moves by lr / bc1 * exp_avg / (sqrt(exp_avg_sq / bc2) +
    eps)."""

    def __init__(self, named_params, lr, betas, eps):
        self.named = list(named_params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.t = 0
        self.exp_avg = {n: torch.zeros_like(p) for n, p in self.named}
        self.exp_avg_sq = {n: torch.zeros_like(p) for n, p in self.named}

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for (name, p), g in zip(self.named, grads):
            m, v = self.exp_avg[name], self.exp_avg_sq[name]
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def _lazy_reg_scale(cfg, interval):
    """Lazy-regularization hyperparameters (training_loop_fullbody.py:
    474-481)."""
    ratio = interval / (interval + 1)
    return (cfg.lr * ratio,
            (cfg.adam_beta1 ** ratio, cfg.adam_beta2 ** ratio))


def _sanitize(grads):
    return [torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)
            for g in grads]


def _phase_grads(loss, params):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _run_g(g, batch, generator, update_w_avg=True):
    n = batch["real_img"].shape[0]
    return g(torch.zeros((n, 0), device=batch["real_img"].device),
             batch["style_input"], batch["retain"], batch["pose"],
             batch["denorm_upper_input"], batch["denorm_lower_input"],
             batch["denorm_upper_mask"], batch["denorm_lower_mask"],
             gt_parsing=batch["gt_parsing"], update_w_avg=update_w_avg,
             noise_mode="random", return_code=True, generator=generator)


def _style_code(g, batch):
    with torch.no_grad():
        return g.style_code(batch["style_input"], batch["retain"])


def build_models(cfg):
    """{"g", "d", "dp", "vgg"}: the four modules of a training run, their
    leaves left for the caller to load (on the meta device, they only say
    each leaf's name, shape and initialiser)."""
    common = dict(c_dim=cfg.c_dim, img_resolution=cfg.resolution,
                  channel_base=cfg.channel_base, channel_max=cfg.channel_max,
                  conv_clamp=cfg.conv_clamp,
                  mbstd_group_size=cfg.mbstd_group_size,
                  num_bf16_res=cfg.d_num_bf16_res, seed=None)
    return dict(
        g=Generator(z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                    img_resolution=cfg.resolution, img_channels=3,
                    channel_base=cfg.channel_base,
                    channel_max=cfg.channel_max, conv_clamp=cfg.conv_clamp,
                    use_noise=cfg.use_noise,
                    mapping_layers=cfg.mapping_layers,
                    num_bf16_res=cfg.g_num_bf16_res, seed=None),
        d=Discriminator(img_channels=3 + 3, **common),
        dp=Discriminator(img_channels=7 + 3, **common),
        vgg=VGG19Features().requires_grad_(False))


class ReferenceTraining:
    """G, the image D (3 + 3 input channels), the parsing D (7 + 3), the
    G-EMA, the VGG19 and one Adam a module, built from `weights` ({"g",
    "d", "dp", "vgg"}: state dicts by the port's names) on `device`.
    `cfg` carries the configuration's training numbers by TrainConfig's
    names. `record` (a callable taking (module, name, gradient)) sees every
    gradient a phase applies."""

    def __init__(self, cfg, weights, device):
        for key, value in PATH.items():
            if getattr(cfg, key) != value:
                raise ValueError(f"the reference step has no {key}="
                                 f"{getattr(cfg, key)!r}")
        self.cfg = cfg
        for name, module in build_models(cfg).items():
            module.to(device).load_state_dict(weights[name])
            setattr(self, name, module)
        self.g_ema = copy.deepcopy(self.g).requires_grad_(False)
        plain = (cfg.lr, (cfg.adam_beta1, cfg.adam_beta2))
        reg = _lazy_reg_scale(cfg, cfg.d_reg_interval) \
            if cfg.r1_gamma != 0 else plain
        self.opt = {
            "g": Adam(self.g.named_parameters(), *plain, cfg.adam_eps),
            "d": Adam(self.d.named_parameters(), *reg, cfg.adam_eps),
            "dp": Adam(self.dp.named_parameters(), *reg, cfg.adam_eps)}
        self.ada_p = torch.tensor(cfg.augment_p_init, dtype=torch.float32,
                                  device=device)
        self.record = None

    def _update(self, name, loss_fn, sanitize=True):
        """One phase: its loss, gradients and Adam step; its metrics,
        detached."""
        loss, metrics = loss_fn()
        params = [p for _, p in self.opt[name].named]
        grads = _phase_grads(loss, params)
        if sanitize and self.cfg.sanitize_grads:
            grads = _sanitize(grads)
        if self.record is not None:
            for (leaf, _), g in zip(self.opt[name].named, grads):
                self.record(name, leaf, g)
        self.opt[name].step(grads)
        return {k: v.detach() if torch.is_tensor(v) else v
                for k, v in metrics.items()}

    @torch.no_grad()
    def _ema(self):
        cfg = self.cfg
        beta = 0.5 ** (cfg.batch_size / max(cfg.ema_kimg * 1000, 1e-8))
        for pe, p in zip(self.g_ema.parameters(), self.g.parameters()):
            pe.copy_(p + (pe - p) * beta)
        for be, b in zip(self.g_ema.buffers(), self.g.buffers()):
            be.copy_(b)

    def _ada(self, real_signs):
        cfg = self.cfg
        if not cfg.use_ada:
            return self.ada_p
        adjust = (torch.sign(real_signs.float() - cfg.ada_target)
                  * cfg.batch_size / (cfg.ada_kimg * 1000))
        return torch.clamp(self.ada_p + adjust, 0.0, 1.0)

    def step(self, batch, generator, do_r1=False):
        """One training step on `batch` (the train step's input dict);
        returns its metrics as the port's step names them."""
        c = build_loss_cores(self.cfg, self.d, self.dp, self.vgg)
        g, ada_p = self.g, self.ada_p

        def gmain():
            return c["g"](_run_g(g, batch, generator), ada_p, batch,
                          generator)

        def dmain():
            with torch.no_grad():
                img, finetune, _, gen_c = _run_g(g, batch, generator,
                                                 update_w_avg=False)
            return c["d"](img, finetune, gen_c, ada_p, batch, generator)

        def dpmain():
            with torch.no_grad():
                n = batch["real_img"].shape[0]
                pred_parsing, gen_c = g.parsing(
                    torch.zeros((n, 0), device=batch["real_img"].device),
                    batch["style_input"], batch["retain"], batch["pose"],
                    generator=generator)
                parsing_soft = torch.softmax(pred_parsing, dim=-1)
            return c["dp"](parsing_soft, gen_c, batch)

        metrics = self._update("g", gmain)
        d_metrics = self._update("d", dmain)
        metrics.update(d_metrics)
        metrics.update(self._update("dp", dpmain, sanitize=False))
        self._ema()
        self.ada_p = self._ada(d_metrics["real_signs"])
        metrics = dict(ada_p=self.ada_p, **metrics)
        metrics.update(r1_penalty=0.0, dp_r1_penalty=0.0)
        if do_r1:
            metrics.update(self._update("d", lambda: c["d_r1"](
                _style_code(g, batch), ada_p, batch, generator)))
            metrics.update(self._update("dp", lambda: c["dp_r1"](
                _style_code(g, batch), batch)))
        return metrics
