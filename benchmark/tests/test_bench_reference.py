"""The plain reference against the port at a narrow width on the CPU, and
the harness's runs with the timed path broken underneath: each fault that
a try-on cell can have must turn `correct` false. (The tests may import
both; the reference imports nothing of the port.)

On the CPU every kernel wrapper of the port computes its plain version,
so a sound run matches the reference exactly there; the cells' limits are
set from chip runs."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.lib import tryon
from benchmark.reference import tryon as reference
from benchmark.traffic import synth

NARROW = {"channel_base": 2048, "channel_max": 128}


def _ctx(cell, tmp_path, seed=2 ** 31 + 29):
    overrides = {"traffic": {"persons": 6, "prep_threads": 2,
                             "batch_size": 2, "rate_per_s": 0.5},
                 "workload": {"warmup_batches": 1, "warmup_requests": 1}}
    ctx = harness.Context(cell, seed, 0.01, False, "cpu",
                          time.perf_counter(), str(tmp_path),
                          overrides=overrides)
    ctx.config["generator"].update(NARROW)
    ctx.workload["check"]["sample"] = 2
    return ctx


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_seeded_weights_load_into_both_sides_by_name(tmp_path):
    from pasta_tpu_torch.models import Generator

    ctx = _ctx("g512_fp32_stream_b8", tmp_path)
    a, b = tryon.seeded_weights(ctx), tryon.seeded_weights(ctx)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ctx.seed += 1
    c = tryon.seeded_weights(ctx)
    assert not torch.equal(a["mapping.fc0.weight"], c["mapping.fc0.weight"])
    port = Generator(**ctx.config["generator"])
    port.load_state_dict(a)                 # strict: the same names
    assert set(port.state_dict()) == set(a)
    strengths = [v for k, v in a.items() if k.endswith("noise_strength")]
    assert strengths and all(v.item() == pytest.approx(0.05) for v in strengths)


def test_reference_matches_the_port_on_the_cpu(tmp_path):
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    ctx = _ctx("g512_fp32_stream_b8", tmp_path)
    root = str(tmp_path / "root")
    names = synth.write_root(root, ctx.seed, 4, 3.0)
    pairs = synth.draw_pairs(names, ctx.seed, 2)
    state = tryon.seeded_weights(ctx)
    model = Generator(**ctx.config["generator"])
    model.load_state_dict(state)
    pipe = TryonPipeline(model.eval(), **ctx.config["serving"])
    got = [out for _, out in pipe.run_stream(root, pairs, batch_size=2,
                                             num_workers=2)][0]
    ref = reference.ReferenceTryon(ctx.config["generator"], state, "cpu",
                                   **ctx.config["serving"])
    items = [reference.prepare_pair(reference.as_root(root), p)
             for p in pairs]
    assert all(bool(it["tiles_fit"]) for it in items)
    want = ref.images(items).numpy()
    np.testing.assert_array_equal(got, want)


def _alter_one(pipe_cls, monkeypatch):
    run_batch = pipe_cls.run_batch

    def altered(self, items):
        out = run_batch(self, items).clone()
        out[0, :64] += 0.05 * (out.max() - out.min())
        return out

    monkeypatch.setattr(pipe_cls, "run_batch", altered)


def _half_left_out(pipe_cls, monkeypatch):
    run_batch = pipe_cls.run_batch

    def half(self, items):
        n = len(items)
        kept = run_batch(self, items[:max(n // 2, 1)])
        return torch.cat([kept] * (n // len(kept)))[:n]

    monkeypatch.setattr(pipe_cls, "run_batch", half)


@pytest.mark.parametrize("cell,fault", [
    ("g512_fp32_stream_b8", None),
    ("g512_fp32_stream_b8", "answer altered"),
    ("g512_fp32_stream_b8", "half the batch left out"),
    ("g512_fp32_single_b1", None),
    ("g512_fp32_single_b1", "answer altered"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                            monkeypatch):
    from pasta_tpu_torch.serving import TryonPipeline

    if fault == "answer altered":
        _alter_one(TryonPipeline, monkeypatch)
    elif fault == "half the batch left out":
        _half_left_out(TryonPipeline, monkeypatch)
    ctx = _ctx(cell, tmp_path)
    run = harness.driver(ctx).run(ctx)
    correct, checks = run.numbers
    assert run.attempted >= 1 and len(checks) == 2
    assert correct == (fault is None), checks
    if fault is None:
        assert all(c["value"] == 0.0 for c in checks.values())
    else:
        assert checks["share_off"]["value"] > 1e-3
