"""The training cell on the CPU at a narrow width: the reference's step
against the port's `make_train_step` on the same states, batches and
generator draws, the record of K1's convolutions (`lib/k1_launches.py`)
against the port's K1 calls, and the driver's whole run with the timed
step broken underneath: each fault a training cell can have must turn
`correct` false. On the CPU K1, K2 and K3 compute their plain versions
and the reference differentiates F.conv2d by autograd, so a sound step
matches the reference to rounding; the cell's limits are set from chip
runs. Each test runs in well under a minute on 4 threads."""

import copy
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.lib import training
from benchmark.lib.roofline import is_k1_conv

CELL = "train512_b4"
# the fashion preset's structure at a width a CPU step takes ~1 s at:
# K1's scope is met at 16 and 8 px (64 and 128 channels), the Ds' top 3
# resolutions are bf16, the VGG19 is whole
NARROW = dict(resolution=64, channel_base=2048, channel_max=128,
              d_reg_interval=2)


def _ctx(tmp_path, seed=2 ** 31 + 29, **train):
    overrides = {"traffic": {"persons": 24, "workers": 2,
                             "tick_interval": 2}}
    ctx = harness.Context(CELL, seed, 0.01, False, "cpu",
                          time.perf_counter(), str(tmp_path),
                          overrides=overrides)
    ctx.config["train"].update(NARROW, **train)
    return ctx


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _program(ctx, weights):
    """The port's state from `weights` and its step, as the loop builds
    them."""
    from pasta_tpu_torch.losses.vgg import VGG19Features
    from pasta_tpu_torch.train.config import TrainConfig
    from pasta_tpu_torch.train.state import init_state
    from pasta_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(**training.train_config(ctx))
    state = init_state(cfg, seed=0, device="cpu")
    for m in training.MODULES:
        getattr(state, m).load_state_dict(weights[m])
    state.g_ema.load_state_dict(weights["g"])
    vgg = VGG19Features().requires_grad_(False)
    vgg.load_state_dict(weights["vgg"])
    return cfg, state, make_train_step(cfg, vgg)


def _batches(cfg, n):
    from pasta_tpu_torch.train.state import example_batch

    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        b = example_batch(cfg, rng)
        b["gt_parsing"] = np.round(b["gt_parsing"])
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


FP32 = dict(d_num_bf16_res=0, vgg_bf16=False)


@pytest.mark.parametrize("dtypes", ["configured", "fp32"])
def test_reference_step_matches_the_ports_on_the_cpu(dtypes, tmp_path):
    """Three steps (R1, regular, R1) from the same weights, batches and
    generator: within the cell's limits with the configuration's bf16
    layers, and all in fp32 under a hundredth of each limit."""
    ctx = _ctx(tmp_path, **(FP32 if dtypes == "fp32" else {}))
    weights = training.seeded_weights(ctx)
    cfg, state, step = _program(ctx, weights)
    batches, kinds = _batches(cfg, 3), [True, False, True]
    generator = training.loop_generator(ctx)
    rec = training.Recorder(ctx, cfg.batch_size)
    for b, kind in zip(batches, kinds):
        rec.step(step, state, b, generator, do_r1_d=kind, do_r1_dp=kind,
                 do_pl=False)
    reference = training.Side(ctx, weights, batches, kinds)
    numbers, _ = training.compare(rec.side(weights), reference,
                                  reference.first_grad)
    limits = dict(ctx.workload["check"]["limits"])
    del limits["rows_off"]
    assert set(numbers) == set(limits)
    share = 1.0 if dtypes == "configured" else 0.01
    assert all(numbers[k] <= share * v for k, v in limits.items()), numbers
    # the first gradient of every module moved, and every leaf it counts
    assert all(reference.first_grad[m] for m in training.MODULES)


def test_k1_records_are_the_ports_k1_calls(tmp_path, monkeypatch):
    """The reference's forward convolutions in K1's scope, a step of each
    kind, are as many as the port's calls of K1 in the same step, forward
    and input gradient, and of the same shapes."""
    from pasta_tpu_torch.ops import conv3x3

    ctx = _ctx(tmp_path)
    weights = training.seeded_weights(ctx)
    cfg, state, step = _program(ctx, weights)
    calls = []
    launch = conv3x3._launch

    def counted(x, w, out_w, bwd, pad):
        out = launch(x, w, out_w, bwd, pad)
        calls.append((tuple(x.shape), x.dtype, bwd, tuple(out.shape)))
        return out

    monkeypatch.setattr(conv3x3, "_launch", counted)
    batches, kinds = _batches(cfg, 2), [True, False]
    generator = training.loop_generator(ctx)
    ports = []
    for b, kind in zip(batches, kinds):
        calls.clear()
        step(state, b, generator, do_r1_d=kind, do_r1_dp=kind, do_pl=False)
        ports.append(list(calls))
    reference = training.Side(ctx, weights, batches, kinds, counting=True)
    assert reference.ops and not training.Side(ctx, weights, batches[:1],
                                               kinds[:1]).ops
    for kind, port in zip(kinds, ports):
        recs = [c for c in reference.ops[kind].convs if is_k1_conv(c)]
        assert port and len(recs) == len(port), kind
        # NCHW records against NHWC calls: the same output shapes
        want = sorted((r["output"][0], r["output"][2], r["output"][3],
                       r["output"][1]) for r in recs)
        assert sorted(c[3] for c in port) == want
        assert {c[1] for c in port} == {torch.float32, torch.bfloat16}
    # an R1 step differentiates K1's input gradients again
    assert len(ports[0]) > len(ports[1])
    assert any(c[2] for c in ports[1])


def _state_unchanged(real):
    def step(state, batch, generator, **kw):
        _, metrics = real(copy.deepcopy(state), batch, generator, **kw)
        return state, metrics
    return step


def _half_batch(real):
    def step(state, batch, generator, **kw):
        n = batch["real_img"].shape[0]
        return real(state, {k: v[:n // 2] for k, v in batch.items()},
                    generator, **kw)
    return step


def _update_doubled(real):
    """G's update made twice where the step makes it: every G leaf moves
    double."""
    def step(state, batch, generator, **kw):
        before = [p.detach().clone() for p in state.g.parameters()]
        state, metrics = real(state, batch, generator, **kw)
        with torch.no_grad():
            for p, b in zip(state.g.parameters(), before):
                p.add_(p - b)
        return state, metrics
    return step


def _r1_dropped(real):
    def step(state, batch, generator, **kw):
        return real(state, batch, generator,
                    **dict(kw, do_r1_d=False, do_r1_dp=False))
    return step


def _d_unchanged(real):
    """The image D's parameters as the step found them."""
    def step(state, batch, generator, **kw):
        before = copy.deepcopy(state.d.state_dict())
        state, metrics = real(state, batch, generator, **kw)
        state.d.load_state_dict(before)
        return state, metrics
    return step


FAULTS = {"state left unchanged": _state_unchanged,
          "half the batch left out": _half_batch,
          "G's update doubled": _update_doubled,
          "R1 dropped": _r1_dropped,
          "D state left unchanged": _d_unchanged}


def dmain_skipped(steps, monkeypatch):
    """Dmain's gradients computed and never applied (the R1 phase's are)."""
    loss_d, apply_grads = steps._loss_d, steps.apply_grads
    pending = []

    def flagged(*args, **kw):
        pending.append(True)
        return loss_d(*args, **kw)

    def applied(opt, module, grads):
        if pending:
            pending.clear()
            return
        apply_grads(opt, module, grads)
    monkeypatch.setattr(steps, "_loss_d", flagged)
    monkeypatch.setattr(steps, "apply_grads", applied)


@pytest.mark.parametrize("fault", [None, *FAULTS, "Gmain skipped",
                                   "Dmain skipped", "EMA skipped"])
def test_a_broken_timed_step_is_not_correct(fault, tmp_path, monkeypatch):
    from pasta_tpu_torch.train import loop, steps

    if fault in FAULTS:
        make = loop.make_train_step

        def broken(cfg, vgg=None):
            return FAULTS[fault](make(cfg, vgg))
        monkeypatch.setattr(loop, "make_train_step", broken)
    elif fault == "Dmain skipped":
        dmain_skipped(steps, monkeypatch)
    elif fault == "EMA skipped":
        monkeypatch.setattr(steps, "ema_update", lambda cfg, state: None)
    elif fault == "Gmain skipped":
        apply_grads = steps.apply_grads

        def skipped(opt, module, grads):
            if module is not getattr(skipped, "g", module):
                apply_grads(opt, module, grads)
        monkeypatch.setattr(steps, "apply_grads", skipped)
        init_state = loop.start_state

        def start(*args, **kw):
            state = init_state(*args, **kw)
            skipped.g = state.g
            return state
        monkeypatch.setattr(loop, "start_state", start)
    ctx = _ctx(tmp_path, **({} if fault is None else {"vgg_weight": 0.0}))
    run = harness.driver(ctx).run(ctx)
    correct, checks = run.numbers
    assert run.attempted == 1 and run.failed == 0
    assert run.e2e["train_sec_per_kimg"] > 0 and run.e2e["setup_s"] > 0
    assert correct == (fault is None), checks
    if fault is not None:
        worst = max(c["value"] for c in checks.values())
        assert worst > 1e-3, checks
