"""The training step, port of pasta_tpu/train/steps.py::make_train_step
(loss parity: reference training/loss_fullbody.py:117-330).

One step runs the reference's phase sequence on a batch -- Gmain, Dmain,
DPmain, EMA, the ADA controller -- each phase seeing the parameters the
phase before it updated; every D and parsing-D phase takes a fresh no-grad
generator draw (`strict_phase_noise`). The lazy R1 phases (Dr1, DPr1) run
on request after the main phases, each with its own double backward and
its own Adam step, as the reference's Dreg / DPreg phases do.

Gradients are taken with torch.autograd.grad with respect to the updated
module's parameters only, sanitized (nan -> 0, +-inf -> +-1e5) where the
JAX step sanitizes them (Gmain, Dmain and the R1 phases), and applied by
that module's Adam. The state is updated in place.

Nothing in a step waits for the card: `state.ada_p` is a 0-d float32 tensor
on the models' device, the controller moves it there, and the step's
metrics come back as detached 0-d tensors. `fetch_metrics` brings the
metrics of any number of steps to the host in one transfer (the training
loop does so once a tick).
"""

from __future__ import annotations

import torch

from .loss_terms import build_loss_cores


def _run_g(g, batch, generator, update_w_avg=True):
    """Generator forward with the style code; (img, finetune,
    pred_parsing, gen_c). update_w_avg moves the mapping's w_avg."""
    n = batch["real_img"].shape[0]
    return g(torch.zeros((n, 0), device=batch["real_img"].device),
             batch["style_input"], batch["retain"], batch["pose"],
             batch["denorm_upper_input"], batch["denorm_lower_input"],
             batch["denorm_upper_mask"], batch["denorm_lower_mask"],
             gt_parsing=batch["gt_parsing"], update_w_avg=update_w_avg,
             noise_mode="random", return_code=True, generator=generator)


def _sanitize(grads):
    return [torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)
            for g in grads]


def _detached(metrics):
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in metrics.items()}


def phase_grads(loss, module):
    """d loss / d (module's parameters); zeros where a parameter is
    unused, as a gradient of the whole parameter tree would have."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def apply_grads(opt, module, grads):
    """One step of `opt` with `grads` as the parameters' gradients."""
    for p, g in zip(module.parameters(), grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


@torch.no_grad()
def ema_update(cfg, state):
    """G-EMA: lerp towards G with beta = 0.5 ** (batch / ema_nimg), the
    buffers copied (training_loop_fullbody.py:641-650)."""
    ema_nimg = cfg.ema_kimg * 1000
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, state.cur_nimg * cfg.ema_rampup)
    beta = 0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8))
    for pe, p in zip(state.g_ema.parameters(), state.g.parameters()):
        pe.copy_(p + (pe - p) * beta)
    for be, b in zip(state.g_ema.buffers(), state.g.buffers()):
        be.copy_(b)


def ada_update(cfg, ada_p, real_signs):
    """ADA controller (training_loop_fullbody.py:656-660, applied every
    step): p moves by sign(E[sign(D(real))] - target) * batch / (ada_kimg
    * 1000), clipped to [0, 1]. float32 tensor math on ada_p's device, as
    the JAX step's; numbers are taken as tensors."""
    ada_p = torch.as_tensor(ada_p, dtype=torch.float32)
    if not cfg.use_ada:
        return ada_p
    real_signs = torch.as_tensor(real_signs, dtype=torch.float32,
                                 device=ada_p.device)
    adjust = (torch.sign(real_signs - cfg.ada_target)
              * cfg.batch_size / (cfg.ada_kimg * 1000))
    return torch.clamp(ada_p + adjust, 0.0, 1.0)


def fetch_metrics(steps_metrics):
    """[{name: 0-d tensor or number}] of any number of steps -> the same
    with Python floats, through one device-to-host transfer."""
    tensors = [v.float() for m in steps_metrics for v in m.values()
               if torch.is_tensor(v)]
    values = iter(torch.stack(tensors).tolist() if tensors else ())
    return [{k: next(values) if torch.is_tensor(v) else float(v)
             for k, v in m.items()} for m in steps_metrics]


def _style_code(state, batch):
    with torch.no_grad():
        return state.g.style_code(batch["style_input"], batch["retain"])


def _loss_g(c, state, batch, generator, update_w_avg):
    """Gmain: G's draw through D, parsing D, L1, VGG and the mask CE."""
    outputs = _run_g(state.g, batch, generator, update_w_avg=update_w_avg)
    return c["g"](outputs, state.ada_p, batch, generator)


def _loss_d(c, state, batch, generator):
    """Dmain on a fresh no-grad draw of the current G."""
    with torch.no_grad():
        img, finetune, _, gen_c = _run_g(state.g, batch, generator,
                                         update_w_avg=False)
    return c["d"](img, finetune, gen_c, state.ada_p, batch, generator)


def _loss_dp(c, state, batch, generator):
    """DPmain on the style branch of a fresh no-grad draw (the parsing
    logits do not depend on the texture branch)."""
    with torch.no_grad():
        n = batch["real_img"].shape[0]
        pred_parsing, gen_c = state.g.parsing(
            torch.zeros((n, 0), device=batch["real_img"].device),
            batch["style_input"], batch["retain"], batch["pose"],
            generator=generator)
        parsing_soft = torch.softmax(pred_parsing, dim=-1)
    return c["dp"](parsing_soft, gen_c, batch)


def _loss_d_r1(c, state, batch, generator, ada_p):
    """Dreg: the image D's lazy R1 with the ada_p Dmain used."""
    return c["d_r1"](_style_code(state, batch), ada_p, batch, generator)


def _loss_dp_r1(c, state, batch):
    """DPreg: the parsing D's lazy R1."""
    return c["dp_r1"](_style_code(state, batch), batch)


def phase_losses(cfg, state, batch, generator, vgg=None):
    """Each phase's (loss, metrics, gradients) from ONE state, nothing
    updated: {"g", "d", "dp", "d_r1", "dp_r1"}, through the loss functions
    the train step runs; the gradients are those of the phase's module, in
    parameter order. The parity checks use it."""
    c = build_loss_cores(cfg, state.d, state.dp, vgg)
    out = {}
    for name, module, fn in (
            ("g", state.g, lambda: _loss_g(c, state, batch, generator,
                                           update_w_avg=False)),
            ("d", state.d, lambda: _loss_d(c, state, batch, generator)),
            ("dp", state.dp, lambda: _loss_dp(c, state, batch, generator)),
            ("d_r1", state.d, lambda: _loss_d_r1(c, state, batch, generator,
                                                 state.ada_p)),
            ("dp_r1", state.dp, lambda: _loss_dp_r1(c, state, batch))):
        loss, metrics = fn()
        out[name] = (loss.detach(), _detached(metrics),
                     phase_grads(loss, module))
    return out


def make_train_step(cfg, vgg=None):
    """Returns train_step(state, batch, generator, do_r1_d=False,
    do_r1_dp=False) -> (state, metrics).

    batch: dict of tensors on the models' device (`state.batch_to`);
    generator: torch.Generator on that device, for the G noise and the ADA
    draws; metrics: dict of detached 0-d tensors on that device (and plain
    zeros for a lazy phase that did not run), for `fetch_metrics`.
    """
    def cores(state):
        return build_loss_cores(cfg, state.d, state.dp, vgg)

    def update(opt, module, loss_and_metrics, sanitize=True):
        """One phase's backward and Adam step; returns its metrics,
        detached, so the phase's graph is freed here."""
        loss, metrics = loss_and_metrics
        grads = phase_grads(loss, module)
        if sanitize and cfg.sanitize_grads:
            grads = _sanitize(grads)
        apply_grads(opt, module, grads)
        return _detached(metrics)

    def main_step(state, batch, generator):
        c = cores(state)
        metrics = update(state.g_opt, state.g, _loss_g(
            c, state, batch, generator, update_w_avg=True))
        d_metrics = update(state.d_opt, state.d,
                           _loss_d(c, state, batch, generator))
        metrics.update(d_metrics)
        # the JAX step does not sanitize the parsing D's main gradients
        metrics.update(update(state.dp_opt, state.dp,
                              _loss_dp(c, state, batch, generator),
                              sanitize=False))
        ema_update(cfg, state)
        ada_p_pre = state.ada_p
        state.ada_p = ada_update(cfg, state.ada_p, d_metrics["real_signs"])
        state.step += 1
        state.cur_nimg += cfg.batch_size
        return dict(ada_p=state.ada_p, **metrics), ada_p_pre

    def r1_d_step(state, batch, ada_p, generator):
        return update(state.d_opt, state.d, _loss_d_r1(
            cores(state), state, batch, generator, ada_p))

    def r1_dp_step(state, batch):
        return update(state.dp_opt, state.dp,
                      _loss_dp_r1(cores(state), state, batch))

    def train_step(state, batch, generator, do_r1_d=False, do_r1_dp=False):
        metrics, ada_p_pre = main_step(state, batch, generator)
        metrics.update(r1_penalty=0.0, dp_r1_penalty=0.0)
        if do_r1_d:
            metrics.update(r1_d_step(state, batch, ada_p_pre, generator))
        if do_r1_dp:
            metrics.update(r1_dp_step(state, batch))
        return state, metrics

    return train_step
