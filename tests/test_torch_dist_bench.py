"""The data-parallel training cell's pieces on the CPU, over gloo ranks:
the plain data-parallel reference (`benchmark/reference/train/ranks.py`)
against the frozen one-process reference at the global batch, the port's
step against the data-parallel reference over the same ranks, and the
cell's files. Each test runs in well under a minute alone."""

import json
import os
import types

import pytest
import torch

import torch_dist_bench_ranks as ranks
from benchmark import harness
from benchmark.lib import training
from benchmark.reference.train.steps import ReferenceTraining

SEED = 2 ** 31 + 29
FP32 = dict(d_num_bf16_res=0, vgg_bf16=False)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_the_ranks_reference_is_the_one_process_reference(tmp_path):
    """Two ranks of 2 rows against one process on the 4 rows: the steps'
    metrics and every gradient the first step applies, equal to fp32
    rounding. G's gradients carry rounding that its instance norms
    amplify: two fp32 orders of summation put them ~0.6% apart (cosine
    0.99998, norms within 1e-4), the Ds' ~2e-4. The draws are made equal by drawing nothing that matters:
    no G noise, ADA at p 0 (each rank has its own generator). Adam's
    learning rate is 0, so that every phase of both sides sees the same
    parameters: Adam turns gradients of rounding noise (G's style-encoder
    biases under an instance norm) into steps of +-lr. The minibatch-std
    group of 4 spans both ranks, and one interleaved D call is taken on
    the global batch's decision (2 rows a rank alone would not allow
    it)."""
    train = dict(FP32, vgg_weight=0.0, use_noise=False, augment_p_init=0.0,
                 mbstd_group_size=4, lr=0.0)
    kinds = [True, False]
    parts = ranks.run(2, "reference", dict(seed=SEED, train=train,
                                           kinds=kinds), tmp_path)
    ctx = ranks.context(1, SEED, **train)
    ctx.config["train"]["batch_size"] = 4
    weights = training.seeded_weights(ctx)
    cfg = types.SimpleNamespace(**training.train_config(ctx))
    one = ReferenceTraining(cfg, weights, "cpu")
    grads = {}
    one.record = lambda m, leaf, g: grads.setdefault((m, leaf), []).append(g)
    gen = torch.Generator().manual_seed(1)
    for i, (b, kind) in enumerate(zip(ranks.batches(cfg, 2), kinds)):
        metrics = {k: float(v) for k, v in one.step(b, gen, kind).items()}
        one.record = None
        for part in parts:
            got = part["metrics"][i]
            assert set(got) == set(metrics)
            for k, v in metrics.items():
                assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), (i, k)
    assert set(parts[0]["grads"]) == set(grads)
    scale = torch.stack([g.norm() for gs in grads.values() for g in gs]
                        ).median()
    tol = {"g": 2e-2, "d": 1e-3, "dp": 1e-3}
    for key, gs in grads.items():
        for part in parts:
            for a, b in zip(part["grads"][key], gs):
                assert (a - b).norm() <= tol[key[0]] * max(b.norm(), scale), \
                    key


@pytest.mark.parametrize("fault", [None, "sum_not_mean"])
def test_the_ports_step_over_ranks_meets_the_reference(fault, tmp_path):
    """The port's steps (R1, regular, regular) on 2 gloo ranks with noise
    and ADA on, the configuration's bf16 layers: every number of the
    cell's check on every rank within its limit, and the ranks' states
    exactly equal. With one rank applying the sum of the ranks' gradients
    and not their mean, the ranks part and the gradients are off."""
    parts = ranks.run(2, "step_vs_reference",
                      dict(seed=SEED, train={}, kinds=[True, False, False],
                           fault=fault), tmp_path)
    limits = harness.Context(ranks.CELL, 1, 1.0, False, "cpu", 0.0,
                             None).workload["check"]["limits"]
    for part in parts:
        numbers = part["numbers"]
        assert set(limits) - set(numbers) == {"rows_off", "ranks_apart"}
        over = {k: numbers[k] for k in numbers
                if k in limits and numbers[k] > limits[k]}
        if fault is None:
            assert part["ranks_apart"] == 0.0 and not over, over
    if fault:
        assert parts[0]["ranks_apart"] > 0
        assert parts[1]["numbers"]["grad_median.g"] > limits["grad_median.g"]


def test_the_cells_files_agree():
    """The four-card configuration is the one-card configuration's with
    the batch and the ranks changed: a card holds the published per-card
    rows, and `reduced` names what differs from `published`. It is the
    benchmark's one four-card cell."""
    bench = harness.declared()
    ctx = harness.Context(ranks.CELL, 1, 1.0, False, "cpu", 0.0, None)
    entry = next(w for w in bench["workloads"] if w["name"] == ranks.CELL)
    assert entry["chips"] == ctx.workload["chips"] == 4
    assert [w["name"] for w in bench["workloads"] if w["chips"] == 4] == \
        [ranks.CELL]
    train, published = ctx.config["train"], ctx.config["published"]
    assert train["data_axis_size"] == entry["chips"]
    assert (train["batch_size"] // train["data_axis_size"]
            == published["batch_size"] // published["data_axis_size"] == 4)
    assert set(ctx.config["reduced"]) == set(published)
    assert all(train[k] != v for k, v in published.items())
    with open(os.path.join(harness.HERE, "configs",
                           "pasta_train512_b4.json")) as f:
        one = json.load(f)
    assert {k for k in train if train[k] != one["train"][k]} == \
        {"batch_size", "data_axis_size"}
    assert ctx.workload["check"]["limits"]["ranks_apart"] == 0
    cell = next(m for m in bench["end_to_end"]
                if m["name"] == "train_sec_per_kimg")
    assert ranks.CELL in cell["workloads"]


def test_the_reference_stream_is_the_loaders():
    """The check's copy of the loader's index stream draws what the port's
    sampler draws, rank by rank; within a pass of 64 persons four ranks'
    48 draws repeat some (so a repeat is no fault)."""
    import itertools

    from benchmark.reference.data.sampler import rank_indices
    from pasta_tpu_torch.data.sampler import infinite_sampler

    drawn = []
    for world in (1, 4):
        for rank in range(world):
            want = list(itertools.islice(infinite_sampler(
                64, rank=rank, num_replicas=world, seed=SEED % 2 ** 32), 12))
            assert rank_indices(64, rank, world, SEED % 2 ** 32, 12) == want
            if world == 4:
                drawn += want
    assert len(set(drawn)) < len(drawn)


@pytest.mark.parametrize("tick_s,ticks", [(33.0, 2), (40.0, 2), (20.0, 2),
                                          (11.0, 3)])
def test_the_window_holds_whole_ticks_of_32_steps_or_more(
        tick_s, ticks, tmp_path, monkeypatch):
    """Rank 0's progress calls open the window after the warm-up tick and
    close it at the first call `--seconds` (30) on or more that is also 32
    steps or more on: a tick of four ranks (~33 s) outlasts the seconds,
    and the window still holds two ticks, as the one-card cell's does."""
    import torch.distributed as dist

    from benchmark.lib import ranks as lib_ranks

    clock = types.SimpleNamespace(now=0.0)
    monkeypatch.setattr(lib_ranks.time, "perf_counter", lambda: clock.now)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ctx = harness.Context(ranks.CELL, SEED, 30.0, False, "cpu", 0.0,
                              None)
        assert ctx.workload["min_window_steps"] == 32
        rec = lib_ranks.RankRecorder(ctx, 16, 1)
        for k in range(1, 8):
            clock.now = k * tick_s
            rec.progress(k * 16 * 16, 2 ** 40)
            if rec.t_close is not None:
                break
        assert rec.step_close - rec.step_open == 16 * ticks
        assert rec.t_close - rec.t_open == pytest.approx(ticks * tick_s)
    finally:
        dist.destroy_process_group()
