"""On the cards (marker `cuda`; skips without them): the data-parallel
training cell's check, calibrated at the cell's size on four cards, and
the port's collectives making no host sync.

The calibration runs the cell's first 3 steps (the loop's own, through
`lib/ranks.py`, the check after them; no window) in one spawn of four
ranks, for sound runs and for each fault planted in the program
(`lib/ranks.py::FAULTS`) and the TF32 control: every sound run must be
correct with `ranks_apart` exactly 0, each fault must fail its number on
every seed, the control must fail. `-s` prints every run's numbers.
`calibrate` runs any list of jobs on four cards (all of them: ~15 min).

    python3 -m pytest -m cuda benchmark/tests/test_bench_ranks_cuda.py -s
"""

import os
import time

import pytest
import torch
import torch.distributed as dist

from benchmark import harness
from benchmark.drivers import train_ranks
from benchmark.lib import check, ranks, tryon

CELL = "train512_b4_x4"
SOUND = [2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203]
FAULTY = [2 ** 31 + s for s in (211, 212, 221, 222, 231, 232, 233)]
# first_loss_gap.g's limit came from 201-203 and 211-222; 231-233 test it
# the number each fault must fail
FAILS = {"sum_not_mean": "ranks_apart", "phase_skipped": "ranks_apart",
         "mbstd_local": "first_loss_gap.g", "tf32": "grad_median.g"}
JOBS = ([(None, s) for s in SOUND]
        + [(c, s) for c in FAILS for s in FAULTY])


def _calibration_rank(rank, world, jobs, root, tmp, init_method, out):
    """Every job of `jobs` in turn in this rank: the cell's loop to its first
    3 steps with the job's control and seed, then the check."""
    from pasta_tpu_torch.train.entry import init_distributed

    device = init_distributed(rank, world, init_method, "cuda")
    try:
        results = []
        for control, seed in jobs:
            ctx = harness.Context(CELL, seed, 0.0, False, str(device),
                                  time.perf_counter(), tmp, control=control,
                                  overrides={"workload": {"check_only": True}})
            res = train_ranks.run_rank(ctx, root, rank, world)
            results.append(dict(numbers=res["numbers"], where=res["where"],
                                ranks_apart=res["ranks_apart"]))
            tryon.release()
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def calibrate(jobs, tmp):
    """{(control, seed): (correct, numbers)} of each job, run in one spawn
    of four ranks on four cards; each is printed."""
    from pasta_tpu_torch.train.entry import spawn

    root = os.path.join(tmp, "root")
    ctx = harness.Context(CELL, SOUND[0], 0.0, False, "cuda", 0.0, tmp)
    ranks.write_root(ctx, root)
    spawn(_calibration_rank, 4, jobs, root, tmp,
          "file://" + os.path.join(tmp, "rendezvous"), tmp)
    parts = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    limits = ctx.workload["check"]["limits"]
    out = {}
    for j, (control, seed) in enumerate(jobs):
        numbers = {k: max(p[j]["numbers"][k] for p in parts)
                   for k in parts[0][j]["numbers"]}
        numbers["ranks_apart"] = max(p[j]["ranks_apart"] for p in parts)
        numbers["rows_off"] = 0         # the loader's rows: the cell's runs
        correct, table = check.judge(numbers, limits)
        print(control, seed, correct, numbers, flush=True)
        out[control, seed] = correct, numbers
    return out, limits


@pytest.fixture(scope="module")
def calibration(tmp_path_factory):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    return calibrate(JOBS, str(tmp_path_factory.mktemp("x4")))


@pytest.mark.cuda
def test_sound_runs_are_correct_and_the_ranks_equal(calibration):
    out, _ = calibration
    for seed in SOUND:
        correct, numbers = out[None, seed]
        assert correct and numbers["ranks_apart"] == 0.0, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("control", list(FAILS))
def test_each_fault_fails_its_number(calibration, control):
    out, limits = calibration
    number = FAILS[control]
    for seed in FAULTY:
        correct, numbers = out[control, seed]
        assert not correct and numbers[number] > limits[number], numbers


@pytest.fixture
def card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pasta_tpu_torch.ops._build import pin_fp32_numerics
    from pasta_tpu_torch.train.entry import init_distributed

    pin_fp32_numerics()
    device = init_distributed(0, 1, "file://" + str(tmp_path / "rdv"),
                              "cuda")
    yield device
    dist.destroy_process_group()


@pytest.mark.cuda
def test_the_collectives_make_no_host_sync_off_a_profiler(card):
    """In an NCCL group (one rank), every collective of the step and its
    span and count make no host sync once warm: the phase all-reduce, the
    summing all-reduces and the minibatch-std gather, forward and
    backward."""
    from pasta_tpu_torch.train import dist as tdist

    def step():
        x = torch.randn(4, 8, device=card, requires_grad=True)
        y = tdist.all_gather_batch(x) * tdist.all_reduce_sum(x.sum())
        loss = tdist.all_reduce_mean(y.square().mean())
        grads = torch.autograd.grad(loss, [x])
        return tdist.reduce_phase(grads, {"loss": loss.detach()}, "Gmain")

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tdist.counts() == {}
