"""On the card (marker `cuda`; skips without one): the control of each
cell's comparison, a fault planted in the training cell's, and a short
sound run with its trace.

The control is the plain reference computed with TF32 on, put in the
program's place, at the cell's own size (the full fashion generator, the
cell's batch and sample; the training cell's three first steps) on three
seeds: it has to come out not correct. So has the reference put in the
training step's place on half of each batch.

    python3 -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

import tempfile
import time

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.declared()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()


def _run(cell, seed, seconds, trace=False, control=False):
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(cell, seed, seconds, trace, "cuda",
                              time.perf_counter(), tmp, control=control)
        run = harness.driver(ctx).run(ctx)
    return ctx, run


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    _, run = _run(cell, seed, 3.0, control=True)
    correct, checks = run.numbers
    print(cell, seed, {k: v["value"] for k, v in checks.items()})
    assert not correct


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 111, 2 ** 31 + 112, 2 ** 31 + 113])
def test_half_the_batch_left_out_is_not_correct(card, seed):
    _, run = _run("train512_b4", seed, 3.0, control="half_batch")
    correct, checks = run.numbers
    print("train512_b4 half_batch", seed,
          {k: v["value"] for k, v in checks.items()})
    assert not correct


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_is_correct_and_reads_its_metrics(card, cell):
    ctx, run = _run(cell, 2 ** 31 + 7, 3.0, trace=True)
    correct, checks = run.numbers
    assert correct, checks
    e2e, layers = harness.metrics_of(cell)
    values = harness.metric_values(ctx, run)
    assert set(values) == {m["name"] for m in layers}
    assert 0 < run.trace.busy_s <= run.trace.window_s
    for name, v in values.items():
        if "_roofline." in name or name.startswith("mfu."):
            assert 0 < v["value"] <= 100, name
