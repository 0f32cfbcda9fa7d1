"""The training step, port of pasta_tpu/train/steps.py::make_train_step
(loss parity: reference training/loss_fullbody.py:117-330).

One step runs the reference's phase sequence on a batch -- Gmain, Gpl (on
request), Dmain, DPmain (twice with `double_d_parsing`), EMA, the ADA
controller -- each phase seeing the parameters the phase before it
updated. Every D and parsing-D phase takes a fresh no-grad generator draw
(`strict_phase_noise`); without it one no-grad forward of the updated G
feeds them all, and with `reuse_g_fakes` Gmain's own detached outputs do.
The lazy R1 phases (Dr1, DPr1) run on request after the main phases, each
with its own double backward and its own Adam step, as the reference's
Dreg / DPreg phases do; they take the D conditioning of the fakes the D
phases saw, or, on the strict path, of the updated G.

With `grad_accum` > 1 the main phases mean their losses, metrics and
gradients over that many microbatches (the JAX step's `_accum_grad`), and
G's w_avg becomes the mean of the microbatches' updates, each taken from
the step's starting value. Gpl and the R1 phases run on the whole batch.

Data parallelism (`train/entry.py`, `train/dist.py`): each rank runs the
step on its rows of the global batch, and the step's reductions over the
batch are global, as under the JAX step's `jit` over a `data` mesh: each
phase's gradients and metrics are meaned over ranks in one all-reduce
before they are sanitized and applied (so the metrics, ADA's `real_signs`
among them, are the global batch's), w_avg and Gpl's `pl_mean` take the
global mean, and the minibatch-std groups, the parsing CE's denominator
and the contextual loss's target mean span the ranks. Microbatches and
the R1 and Gpl prefixes are each rank's own (`train/config.py` says what
that selects). Every rank ends the step with the same bits.

Gradients are taken with torch.autograd.grad with respect to the
parameters the module's Adam updates (freeze-D leaves the frozen ones
out), sanitized (nan -> 0, +-inf -> +-1e5) where the JAX step sanitizes
them (Gmain, Gpl, Dmain and the R1 phases), and applied by that Adam. The
state is updated in place.

Nothing in a step waits for the card: `state.ada_p` and `state.pl_mean` are
0-d float32 tensors on the models' device, the step moves them there, and
the step's metrics come back as detached 0-d tensors. `fetch_metrics`
brings the metrics of any number of steps to the host in one transfer (the
training loop does so once a tick).
"""

from __future__ import annotations

import math

import torch

from . import dist as tdist
from .loss_terms import build_loss_cores
from .state import trained_named_params


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


def phase_grads(loss, params):
    """d loss / d params; zeros where a parameter is unused, as a gradient
    of the whole parameter tree would have."""
    params = list(params)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def trained_params(opt, module):
    """The parameters of `module` that `opt` updates, in module order."""
    return [p for _, p in trained_named_params(opt, module)]


def apply_grads(opt, module, grads):
    """One step of `opt` with `grads` as the gradients of
    `trained_params(opt, module)`."""
    for p, g in zip(trained_params(opt, module), grads):
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


def _microbatches(batch, a):
    """`batch` cut into `a` equal consecutive microbatches."""
    if a == 1:
        return [batch]
    n = batch["real_img"].shape[0]
    if n % a:
        raise ValueError(f"batch {n} does not split into grad_accum={a} "
                         "microbatches")
    m = n // a
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(a)]


def _fakes(img, finetune, pred_parsing, gen_c):
    """What the D phases take from a generator forward, detached."""
    return dict(fake_img=img.detach(), fake_finetune=finetune.detach(),
                fake_parsing_soft=torch.softmax(pred_parsing.detach(), -1),
                gen_c=gen_c.detach())


def _loss_g(c, state, batch, generator, update_w_avg, keep=None):
    """Gmain: G's draw through D, parsing D, L1, VGG, the mask CE and the
    contextual loss. `keep`: a dict that takes the draw's detached fakes."""
    outputs = _run_g(state.g, batch, generator, update_w_avg=update_w_avg)
    if keep is not None:
        keep.update(_fakes(*outputs))
    return c["g"](outputs, state.ada_p, batch, generator)


def _loss_pl(cfg, state, batch, generator, pl_noise=None):
    """Gpl, the lazy path-length regularizer (pasta_tpu/train/steps.py::
    pl_loss_fn; StyleGAN2's formula): the spread of |J_ws^T y| over random
    image-space directions y, on batch // pl_batch_shrink samples, with the
    gradient through ws into the mapping and through the double backward
    into the synthesis. `pl_noise`: y before its 1/sqrt(H*W) scaling, drawn
    from `generator` when None. Returns (loss, metrics, new pl_mean)."""
    n = batch["real_img"].shape[0]
    bs = max(n // max(cfg.pl_batch_shrink, 1), 1)
    sub = {k: v[:bs] for k, v in batch.items()}
    z = torch.zeros((bs, 0), device=sub["real_img"].device)
    _, feats, ws = state.g.style_and_ws(z, sub["style_input"],
                                        sub["retain"])
    img, _ = state.g.style_branch(ws, feats, sub["pose"], generator=generator)
    if pl_noise is None:
        pl_noise = torch.randn(img.shape, generator=generator,
                               device=img.device, dtype=img.dtype)
    pl_noise = pl_noise / math.sqrt(img.shape[1] * img.shape[2])
    (pl_grads,) = torch.autograd.grad((img * pl_noise).sum(), ws,
                                      create_graph=True)
    # [N, num_ws, w_dim] -> per-sample length: sqrt(mean_ws sum_dim g^2)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    penalty, pl_mean = pl_penalty(pl_lengths, state.pl_mean, cfg.pl_decay)
    loss = penalty * cfg.pl_weight * cfg.g_reg_interval
    return loss, dict(pl_penalty=penalty), pl_mean


def pl_penalty(pl_lengths, pl_mean, decay):
    """(penalty, new pl_mean) of Gpl's path lengths: pl_mean moves towards
    the lengths' mean over the global batch (every rank's), with the
    gradient through that mean, and the penalty is the lengths' mean
    squared distance from it."""
    pl_mean = pl_mean + (tdist.all_reduce_mean(pl_lengths.mean())
                         - pl_mean) * decay
    return (pl_lengths - pl_mean).square().mean(), pl_mean


def _loss_d(c, state, batch, generator):
    """Dmain on the shared fakes in `batch`, or on a fresh no-grad draw of
    the current G."""
    if "fake_img" in batch:
        img, finetune, gen_c = (batch["fake_img"], batch["fake_finetune"],
                                batch["gen_c"])
    else:
        with torch.no_grad():
            img, finetune, _, gen_c = _run_g(state.g, batch, generator,
                                             update_w_avg=False)
    return c["d"](img, finetune, gen_c, state.ada_p, batch, generator)


def _loss_dp(c, state, batch, generator):
    """DPmain on the shared fakes in `batch`, or on the style branch of a
    fresh no-grad draw (the parsing logits do not depend on the texture
    branch)."""
    if "fake_parsing_soft" in batch:
        parsing_soft, gen_c = batch["fake_parsing_soft"], batch["gen_c"]
    else:
        with torch.no_grad():
            n = batch["real_img"].shape[0]
            pred_parsing, gen_c = state.g.parsing(
                torch.zeros((n, 0), device=batch["real_img"].device),
                batch["style_input"], batch["retain"], batch["pose"],
                generator=generator)
            parsing_soft = torch.softmax(pred_parsing, dim=-1)
    return c["dp"](parsing_soft, gen_c, batch)


def _loss_d_r1(c, state, batch, generator, ada_p, gen_c=None):
    """Dreg: the image D's lazy R1 with the ada_p Dmain used, conditioned
    on `gen_c`, or on the current G's style code when None."""
    if gen_c is None:
        gen_c = _style_code(state, batch)
    return c["d_r1"](gen_c, ada_p, batch, generator)


def _loss_dp_r1(c, state, batch, gen_c=None):
    """DPreg: the parsing D's lazy R1."""
    if gen_c is None:
        gen_c = _style_code(state, batch)
    return c["dp_r1"](gen_c, batch)


def phase_losses(cfg, state, batch, generator, vgg=None, pl_noise=None):
    """Each phase's (loss, metrics, gradients) from ONE state, nothing
    updated: {"g", "d", "dp", "d_r1", "dp_r1"} and, with pl_weight != 0,
    "pl" (its metrics carry the new pl_mean), through the loss functions
    the train step runs on its whole batch; the gradients are those of
    every parameter of the phase's module, in parameter order. The parity
    checks use it."""
    c = build_loss_cores(cfg, state.d, state.dp, vgg)

    def pl():
        loss, metrics, pl_mean = _loss_pl(cfg, state, batch, generator,
                                          pl_noise)
        return loss, dict(metrics, pl_mean=pl_mean)

    phases = [
        ("g", state.g, lambda: _loss_g(c, state, batch, generator,
                                       update_w_avg=False)),
        ("d", state.d, lambda: _loss_d(c, state, batch, generator)),
        ("dp", state.dp, lambda: _loss_dp(c, state, batch, generator)),
        ("d_r1", state.d, lambda: _loss_d_r1(c, state, batch, generator,
                                             state.ada_p)),
        ("dp_r1", state.dp, lambda: _loss_dp_r1(c, state, batch))]
    if cfg.pl_weight != 0:
        phases.append(("pl", state.g, pl))
    out = {}
    for name, module, fn in phases:
        loss, metrics = fn()
        out[name] = (loss.detach(), _detached(metrics),
                     phase_grads(loss, module.parameters()))
    return out


def make_train_step(cfg, vgg=None):
    """Returns train_step(state, batch, generator, do_r1_d=False,
    do_r1_dp=False, do_pl=False, pl_noise=None) -> (state, metrics).

    batch: dict of tensors on the models' device (`state.batch_to`);
    generator: torch.Generator on that device, for the G noise, the ADA
    draws and Gpl's directions (`pl_noise` gives those instead: the parity
    tests hand both packages the same); metrics: dict of detached 0-d
    tensors on that device (and plain zeros for a lazy phase that did not
    run), for `fetch_metrics`.
    """
    reuse_fakes = (cfg.reuse_g_fakes and not cfg.strict_phase_noise
                   and cfg.grad_accum == 1)

    def cores(state):
        return build_loss_cores(cfg, state.d, state.dp, vgg)

    def update(phase, opt, module, loss_fn, batch, sanitize=True,
               accum=cfg.grad_accum):
        """One phase's backward and Adam step, its losses, metrics and
        gradients meaned over `accum` microbatches; each microbatch's graph
        is freed before the next one's forward. Returns the metrics,
        detached. `phase` names the phase to its all-reduce's span."""
        params = trained_params(opt, module)
        grads = metrics = None
        for mb in _microbatches(batch, accum):
            loss, m = loss_fn(mb)
            g = phase_grads(loss, params)
            m = _detached(m)
            if grads is None:
                grads, metrics = g, m
            else:
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: v + m[k] for k, v in metrics.items()}
        if accum > 1:
            grads = [g / accum for g in grads]
            metrics = {k: v / accum for k, v in metrics.items()}
        # the means over ranks, then sanitized, as the JAX step's psum
        grads, metrics = tdist.reduce_phase(grads, metrics, phase)
        if sanitize and cfg.sanitize_grads:
            grads = _sanitize(grads)
        apply_grads(opt, module, grads)
        return metrics

    def g_main(state, batch, generator, c, keep):
        """Gmain; under grad_accum, each microbatch's w_avg update is taken
        from the step's starting w_avg, and w_avg becomes their mean. With
        ranks, w_avg becomes the mean of the ranks' too: the update is
        linear in the batch mean of w, so that is the global batch's."""
        a = cfg.grad_accum
        w_avg = state.g.mapping.w_avg
        if a == 1:
            metrics = update("Gmain", state.g_opt, state.g, lambda mb: _loss_g(
                c, state, mb, generator, update_w_avg=True, keep=keep),
                batch)
        else:
            start, moved = w_avg.clone(), []

            def loss_fn(mb):
                w_avg.copy_(start)
                out = _loss_g(c, state, mb, generator, update_w_avg=True)
                moved.append(w_avg.clone())
                return out

            metrics = update("Gmain", state.g_opt, state.g, loss_fn, batch)
            w_avg.copy_(torch.stack(moved).sum(0) / a)
        if tdist.grouped():
            with torch.no_grad():
                w_avg.copy_(tdist.all_reduce_mean(w_avg))
        return metrics

    def main_step(state, batch, generator, do_pl, pl_noise):
        c = cores(state)
        kept = {} if reuse_fakes else None
        metrics = g_main(state, batch, generator, c, kept)
        if do_pl:
            if cfg.pl_weight == 0:
                raise ValueError("do_pl needs pl_weight != 0")
            new = {}

            def pl_loss(b):
                loss, m, new["pl_mean"] = _loss_pl(cfg, state, b, generator,
                                                   pl_noise)
                return loss, m

            metrics.update(update("Gpl", state.g_opt, state.g, pl_loss,
                                  batch, accum=1))
            state.pl_mean = new["pl_mean"].detach()
        elif cfg.pl_weight != 0:
            metrics.update(pl_penalty=0.0)

        # the D phases' fakes: Gmain's own, or one shared no-grad forward of
        # the updated G, or none (each phase draws afresh)
        batch_d = batch
        if reuse_fakes:
            batch_d = dict(batch, **kept)
        elif not cfg.strict_phase_noise:
            with torch.no_grad():
                batch_d = dict(batch, **_fakes(*_run_g(
                    state.g, batch, generator, update_w_avg=False)))

        d_metrics = update("Dmain", state.d_opt, state.d,
                           lambda mb: _loss_d(c, state, mb, generator),
                           batch_d)
        metrics.update(d_metrics)
        # the JAX step does not sanitize the parsing D's main gradients
        for _ in range(2 if cfg.double_d_parsing else 1):
            dp_metrics = update("DPmain", state.dp_opt, state.dp,
                                lambda mb: _loss_dp(c, state, mb, generator),
                                batch_d, sanitize=False)
        metrics.update(dp_metrics)
        ema_update(cfg, state)
        ada_p_pre = state.ada_p
        state.ada_p = ada_update(cfg, state.ada_p, d_metrics["real_signs"])
        state.step += 1
        state.cur_nimg += cfg.batch_size
        return (dict(ada_p=state.ada_p, **metrics), ada_p_pre,
                batch_d.get("gen_c"))

    def train_step(state, batch, generator, do_r1_d=False, do_r1_dp=False,
                   do_pl=False, pl_noise=None):
        metrics, ada_p_pre, gen_c = main_step(state, batch, generator, do_pl,
                                              pl_noise)
        metrics.update(r1_penalty=0.0, dp_r1_penalty=0.0)
        if do_r1_d:
            metrics.update(update(
                "Dr1", state.d_opt, state.d, lambda b: _loss_d_r1(
                    cores(state), state, b, generator, ada_p_pre, gen_c),
                batch, accum=1))
        if do_r1_dp:
            metrics.update(update(
                "DPr1", state.dp_opt, state.dp, lambda b: _loss_dp_r1(
                    cores(state), state, b, gen_c), batch, accum=1))
        return state, metrics

    return train_step
