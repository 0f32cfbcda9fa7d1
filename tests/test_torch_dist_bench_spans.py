"""The port's spans and counters of the data-parallel step and of the
training loop (`train/dist.py`, `train/loop.py`), and the data-parallel
cell's three readers (`benchmark/metrics/train_x4.*.py`) on a fixed run.
The spans are recorded only under a profiler; without a process group
the collectives record and count nothing."""

import statistics
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_dist_bench_ranks as ranks
from benchmark import harness
from pasta_tpu_torch import tracing
from pasta_tpu_torch.train import dist as tdist

PHASES = ["Gmain", "Dmain", "DPmain", "Dr1", "DPr1"]


def test_collectives_are_traced_and_counted_under_a_profiler(tmp_path):
    """An R1 step over 2 gloo ranks: off a profiler no span and no count;
    under one, one `allreduce` span a phase, in order, whose bytes are the
    flat buffer's (the phase's parameters and its tensor metrics, float32),
    the minibatch-std gathers and the parsing denominators' sums, each
    counted with its bytes."""
    parts = ranks.run(2, "traced_step", {}, tmp_path)
    for part in parts:
        assert part[False] == {"spans": [], "counts": {}}
        spans, counts = part[True]["spans"], part[True]["counts"]
        reduced = [a for name, a in spans if name == "allreduce"]
        assert [a["phase"] for a in reduced] == PHASES
        module = {"Gmain": "g", "Dmain": "d", "DPmain": "dp", "Dr1": "d",
                  "DPr1": "dp"}
        for a in reduced:
            params = 4 * part["params"][module[a["phase"]]]
            assert params < a["bytes"] <= params + 4 * 16, a
        for kind in ("allreduce", "all_gather_batch", "all_reduce_sum"):
            mine = [a["bytes"] for name, a in spans if name == kind]
            assert mine and counts[kind] == {"calls": len(mine),
                                             "bytes": sum(mine)}, kind
    assert parts[0][True]["spans"] == parts[1][True]["spans"]


def test_the_profiled_ranges_of_the_port_s_spans():
    """`lib/ranks.py::port_ranges` finds each span's host range in a
    profile, nested ones too, with the NCCL kernel time under it (none
    on the CPU)."""
    from benchmark.lib.ranks import port_ranges

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("train_step"):
            with tracing.span("allreduce", phase="Gmain"):
                torch.ones(8).sum()
    got = port_ranges(prof.events())
    assert [(name, us) for name, _, _, us in got] == [
        ("train_step", 0), ("allreduce", 0)]
    (_, a, b, _), (_, c, d, _) = got
    assert a <= c <= d <= b


def test_collectives_without_a_group_record_nothing():
    x = torch.ones(3, requires_grad=True)
    tdist.reset_counts()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = tdist.all_gather_batch(x) + tdist.all_reduce_sum(x)
        tdist.all_reduce_mean(y).sum().backward()
        assert tdist.reduce_phase([x], {"a": y.sum()}, "Gmain")[0][0] is x
    assert tracing.snapshot() == [] and tdist.counts() == {}


def test_the_loop_traces_its_steps_and_its_loader(tmp_path, monkeypatch):
    """`training_loop` with a stub step at the smoke configuration: under a
    profiler, one `train_step` span a step (its index, whether it ran R1,
    the rank) and one `loader_wait` span a batch taken; off it none."""
    from pasta_tpu_torch.data.synthetic import write_dataset_root
    from pasta_tpu_torch.data.trainsets import TryonTrainDataset
    from pasta_tpu_torch.train import loop
    from pasta_tpu_torch.train.config import smoke_config

    def make_train_step(cfg, vgg=None):
        def step(state, batch, generator, **kw):
            return state, {"g_loss": torch.zeros(()),
                           "d_loss": torch.zeros(()),
                           "ada_p": torch.zeros(())}
        return step

    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    cfg = smoke_config(1, d_reg_interval=2)
    root = str(tmp_path / "root")
    write_dataset_root(root, 4, seed=0)
    dataset = TryonTrainDataset(root, seed=0, resolution=cfg.resolution)
    seen = {}
    for traced in (False, True):
        tracing.clear()
        run = dict(run_dir=str(tmp_path / f"run{traced}"), total_steps=3,
                   tick_interval=3, num_workers=1, device="cpu")
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                loop.training_loop(cfg, dataset, **run)
        else:
            loop.training_loop(cfg, dataset, **run)
        seen[traced] = tracing.snapshot()
    assert seen[False] == []
    steps = [s.attrs for s in seen[True] if s.name == "train_step"]
    assert steps == [dict(step=i, r1=i % 2 == 0, rank=0) for i in range(3)]
    assert sum(s.name == "loader_wait" for s in seen[True]) == 3


def _rank(rank, world=4):
    """One rank's traced record of 2 steps: Gmain, Dmain and DPmain
    all-reduces whose NCCL kernels take 4, 2 and 2 ms (plus `rank` x 0.5
    ms on Gmain), Gmain entered `rank` ms later than rank 0 in the first
    step and 2 x `rank` ms in the second, a gather's span with an NCCL
    kernel of its own, and loader waits of 1 and 3 ms."""
    ms, ns = 1000.0, 10 ** 6            # us, and ms in ns
    steps = [(0.0, 100 * ms), (100 * ms, 200 * ms)]
    ranges, spans = [], []
    for step, (t0, _) in enumerate(steps):
        ranges.append(("all_gather_batch", t0 + 2 * ms, t0 + 3 * ms, 4 * ms))
        for i, (phase, dur) in enumerate((("Gmain", 4 + 0.5 * rank),
                                          ("Dmain", 2), ("DPmain", 2))):
            s = t0 + (10 + 20 * i) * ms
            ranges.append(("allreduce", s, s + ms, dur * ms))
            entry = (step * 100 + 10 * i + rank * (step + 1)) * ns
            spans.append(dict(name="allreduce", start=entry, end=entry + ns,
                              attrs=dict(phase=phase, bytes=4 * 10 ** 6)))
        spans.append(dict(name="loader_wait", start=0, end=(1 + 2 * step) * ns,
                          attrs={}))
    return dict(world=world, steps=steps, ranges=ranges, spans=spans,
                counts={"allreduce": {"calls": 6, "bytes": 24 * 10 ** 6}})


def _read(metric, run):
    return harness.reader(metric)(run)


def test_the_readers_on_a_fixed_run():
    run = types.SimpleNamespace(ranks=[_rank(r) for r in range(4)], notes=[])
    # rank 3's steps: 4 + 1.5 + 2 + 2 ms, the gather left out
    assert _read("train_x4.allreduce_ms", run) == pytest.approx(9.5)
    assert any("Gmain: 4.0 MB" in n and "bus" in n for n in run.notes)
    assert any("counted: allreduce 6 calls" in n for n in run.notes)
    # Gmain entered 0-3 ms apart in step 1, 0-6 ms in step 2
    assert _read("train_x4.rank_wait_ms", run) == pytest.approx(4.5)
    assert _read("train_x4.loader_wait_ms", run) == pytest.approx(
        statistics.median([1, 3] * 4))


@pytest.mark.parametrize("metric", ["train_x4.allreduce_ms",
                                    "train_x4.rank_wait_ms",
                                    "train_x4.loader_wait_ms"])
def test_the_readers_find_nothing_on_a_program_without_spans(metric):
    """A program without the spans and counters (the port before them):
    every reader returns None and raises nothing."""
    bare = dict(_rank(0), spans=[], ranges=[], counts=None)
    for run in (types.SimpleNamespace(ranks=[bare, bare], notes=[]),
                types.SimpleNamespace(ranks=[None, None], notes=[]),
                types.SimpleNamespace(notes=[])):
        assert _read(metric, run) is None
