"""What each rank of the data-parallel training cell uses around the
port's `training_loop` (`drivers/train_ranks.py` spawns the ranks and runs
the loop in each): `RankRecorder`, which wraps the step the loop builds
and answers its progress calls alike on every rank, the traced span of
each rank (`RankSpan`), and, with the program's state freed, the check of
the loop's first steps against the plain data-parallel reference
(`reference/train/ranks.py`) on the same ranks and cards (`check_rank`,
`count_ops`, `ranks_apart`, `rows_off`).

`ctx.control` (tests and calibration only) puts a fault into the rank's
program (`FAULTS`) or, with any other true value, the reference at TF32
in the program's place.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..reference.data.preprocess import load_person
from ..reference.data.roots import as_root
from ..reference.data.sampler import rank_indices
from ..reference.train import ranks as reference_ranks
from ..traffic import synth
from . import trace as tr
from . import training

MODULES = ("g", "d", "dp", "g_ema")


class RankSpan(tr.Span):
    """`trace.Span` that also keeps what the collectives' readers need
    (`traced()`): the host ranges of the port's spans (`pasta.<name>`)
    with the device time of the NCCL kernels launched inside each, the
    traced steps' host ranges, and the port's own spans and collective
    counts. A kernel is the range's where the profiler's event tree puts
    its launch under it."""

    def __enter__(self):
        from pasta_tpu_torch import tracing
        from pasta_tpu_torch.train import dist as tdist

        tracing.clear()
        getattr(tdist, "reset_counts", lambda: None)()
        return super().__enter__()

    def read(self, events):
        super().read(events)
        self.ranges = port_ranges(events)

    def traced(self, world):
        from pasta_tpu_torch import tracing
        from pasta_tpu_torch.train import dist as tdist

        counts = getattr(tdist, "counts", None)
        return dict(
            world=world, ranges=self.ranges,
            steps=[(s, e) for name, s, e in self.labels
                   if name == "train_step"],
            spans=[dict(name=s.name, start=s.start, end=s.end,
                        attrs=dict(s.attrs)) for s in tracing.snapshot()],
            counts=counts() if counts else None)


def port_ranges(events):
    """[(name, start us, end us, us of the NCCL kernels launched inside)]
    of the port's spans among a profile's host events."""
    out = []
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("pasta.")):
            nccl = sum(k.duration for d in _descendants(e)
                       for k in d.kernels if "nccl" in k.name.lower())
            out.append((e.name[len("pasta."):], e.time_range.start,
                        e.time_range.end, nccl))
    return out


def _descendants(event):
    for child in event.cpu_children:
        yield child
        yield from _descendants(child)


class RankRecorder(training.Recorder):
    """`training.Recorder` in one rank of the group. The window opens at
    the `warmup_ticks`-th progress call and closes at the first one that
    rank 0 finds `seconds` later or more and the workload's
    `min_window_steps` steps on or more: rank 0 decides and broadcasts,
    so that every rank answers `abort` alike and stops at the same step.
    With a trace the profiler starts at that closing call, the next
    `trace_steps` steps are marked where each starts, and the step after
    them marks once more, stops the profiler and raises `Stop`. With the
    workload's `check_only`, the step after the kept ones raises `Stop`
    (no window). `state` is the program's state after the last step run."""

    def __init__(self, ctx, batch_size, world):
        super().__init__(ctx, batch_size)
        self.world, self.state, self.traced = world, None, None
        self.check_only = ctx.workload.get("check_only", False)
        self.min_steps = ctx.workload["min_window_steps"]

    def step(self, real, state, batch, generator, **kw):
        k = self.calls
        self.calls += 1
        if self.check_only and k == self.kept:
            raise training.Stop
        if k < self.kept:
            self.batches.append({n: t.clone() for n, t in batch.items()})
            self.kinds.append(bool(kw.get("do_r1_d")))
        if self.span is not None:
            tr.mark()
            if len(self.traced_kinds) == self.trace_steps:
                self.span.__exit__(None, None, None)
                self.traced = self.span.traced(self.world)
                raise training.Stop
            self.traced_kinds.append(bool(kw.get("do_r1_d")))
        with tr.label("train_step"):
            state, metrics = real(state, batch, generator, **kw)
        self.state = state
        self.metrics.append(metrics)
        if k == 0:
            self.first = self._clone(state, lambda opt, p: opt.state.get(
                p, {}).get("exp_avg", torch.zeros_like(p)))
        if k == self.kept - 1:
            self.after = self._clone(state, lambda opt, p: p)
            self.after["g_ema"] = {n: p.detach().clone() for n, p in
                                   state.g_ema.named_parameters()}
        return state, metrics

    def progress(self, nimg, total):
        now = time.perf_counter()
        self.ticks += 1
        self.tick_times.append(now)
        if self.ticks == self.warmup:
            self.t_open, self.step_open = now, nimg // self.batch_size
            self.ctx.stamp("warm-up")
        elif self.t_open is not None and self.t_close is None:
            steps = nimg // self.batch_size - self.step_open
            due = (now - self.t_open >= self.ctx.seconds
                   and steps >= self.min_steps)
            flag = torch.tensor([int(due)], device=self.ctx.device)
            dist.broadcast(flag, 0)
            if flag.item():
                self.t_close, self.step_close = now, nimg // self.batch_size
                if self.trace_steps:
                    self.span = RankSpan().__enter__()


def ranks_apart(state):
    """The largest difference between two ranks' values of any parameter
    of G, the image D, the parsing D and the G-EMA (inf where one is not
    finite): every rank takes part."""
    worst = 0.0
    for m in MODULES:
        flat = torch.cat([p.detach().reshape(-1).float()
                          for p in getattr(state, m).parameters()])
        hi = flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(flat, op=dist.ReduceOp.MIN)
        gap = float((hi - flat).max())
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst


def write_root(ctx, root):
    """Write the cell's synthetic root, then `<root>.written` (or, where
    the writing fails, `<root>.failed`): the ranks start while it is
    written and wait for it (`wait_for_root`) before they read it."""
    t = ctx.traffic
    try:
        synth.write_root(root, ctx.seed, t["persons"], t["jitter_px"])
    except BaseException:
        open(root + ".failed", "w").close()
        raise
    open(root + ".written", "w").close()


def wait_for_root(root):
    while not os.path.exists(root + ".written"):
        if os.path.exists(root + ".failed"):
            raise RuntimeError(f"the root {root} was not written")
        time.sleep(0.05)


def rows_off(rows, root, resolution, seed):
    """Rows that are not the person the loader's index stream puts there:
    `rows[r]` holds rank r's kept rows in the order it drew them (8-bit
    real images, [n, H, W, 3]), and rank r of len(rows) draws the
    positions r, r + n, ... of the stream of `seed`
    (`reference/data/sampler.py`), which may repeat a person."""
    import cv2

    data = as_root(root)
    persons = []
    for name in data.list("image"):
        img = load_person(data, name).image.astype(np.float32)
        if resolution != img.shape[0]:
            img = np.round(cv2.resize(img, (resolution, resolution),
                                      interpolation=cv2.INTER_AREA))
        persons.append(torch.from_numpy(img))
    off = 0
    for r, got in enumerate(rows):
        want = rank_indices(len(persons), r, len(rows), seed, len(got))
        off += sum(not torch.equal(row.float(), persons[i])
                   for row, i in zip(got, want))
    return off


def _sum_not_mean(rank, world, tdist, layers):
    """Rank 1 applies the sum of the ranks' gradients, not their mean."""
    real = tdist.reduce_phase

    def reduce_phase(grads, metrics, phase=None):
        grads, metrics = real(grads, metrics, phase)
        return ([g * world for g in grads] if rank == 1 else grads), metrics
    tdist.reduce_phase = reduce_phase


def _phase_skipped(rank, world, tdist, layers):
    """Rank 1 keeps its own Dmain gradients and metrics (it still takes
    part in the all-reduce, so that the ranks' collectives stay
    matched)."""
    real = tdist.reduce_phase

    def reduce_phase(grads, metrics, phase=None):
        out = real(grads, metrics, phase)
        return (grads, metrics) if rank == 1 and phase == "Dmain" else out
    tdist.reduce_phase = reduce_phase


def _mbstd_local(rank, world, tdist, layers):
    """The minibatch-std groups of each rank's own rows alone."""
    layers.all_gather_batch = lambda x: x


FAULTS = {"sum_not_mean": _sum_not_mean, "phase_skipped": _phase_skipped,
          "mbstd_local": _mbstd_local}


@contextlib.contextmanager
def planted(control, rank, world):
    """Inside, the program carries the fault `control` names (none where
    it names none)."""
    from pasta_tpu_torch.nn import layers
    from pasta_tpu_torch.train import dist as tdist

    saved = tdist.reduce_phase, layers.all_gather_batch
    if control in FAULTS:
        FAULTS[control](rank, world, tdist, layers)
    try:
        yield
    finally:
        tdist.reduce_phase, layers.all_gather_batch = saved


def _rank_generator(rank, world):
    def loop_generator(ctx):
        """A torch.Generator seeded as `training_loop` seeds rank
        `rank`'s: (seed + 1) * world + rank."""
        return torch.Generator(device=ctx.device).manual_seed(
            (training.loop_seed(ctx) + 1) * world + rank)
    return loop_generator


@contextlib.contextmanager
def _reference(rank, world):
    """Inside, `training.Side` runs the data-parallel reference in this
    rank, with the generator the loop gives it."""
    saved = training.ReferenceTraining, training.loop_generator
    training.ReferenceTraining = reference_ranks.RankTraining
    training.loop_generator = _rank_generator(rank, world)
    try:
        with reference_ranks.couple():
            yield
    finally:
        training.ReferenceTraining, training.loop_generator = saved


def check_rank(ctx, program, weights, batches, kinds, rank, world):
    """({number: value}, {number: where}) of this rank's first steps
    against the data-parallel reference on its rows (`training.compare`).
    Every rank calls it together."""
    with _reference(rank, world):
        reference = training.Side(ctx, weights, batches, kinds)
        if ctx.control and ctx.control not in FAULTS:
            program = training.Side(ctx, weights, batches, kinds, tf32=True)
    return training.compare(program, reference, reference.first_grad)


def count_ops(ctx, weights, batches, kinds, rank, world):
    """{do_r1: the operations of this rank's step} of the reference's first
    R1 step and first regular step on this rank's rows, K1's convolutions
    made as the port launches them (`training.Side`'s counting pass; the
    collectives are no operations). Every rank calls it together."""
    with _reference(rank, world):
        return training.Side(ctx, weights, batches[:2], kinds[:2],
                             counting=True).ops
