"""What the training driver needs around the port's `training_loop`: the
configuration as `TrainConfig` takes it, the seeded weights of the four
models, the wrapper around the step the loop builds, and the check of the
loop's first steps against the plain reference.

The check follows the loop's first `steps` steps (from the benchmark's
weights, an R1 step and then regular ones) with the reference's step, on
the batches those steps consumed and with a torch.Generator seeded as the
loop seeds its own, so every random draw repeats. Its numbers:

- `first_loss_gap.g`, `first_loss_gap.r1`: G's six losses and the two R1
  penalties of the first step, the worst |program - reference| /
  |reference|;
- `grad_median.<m>` for G, the image D and the parsing D (`g`, `d`,
  `dp`): the gradient each parameter's Adam holds after the first step
  (exp_avg, the gradient itself at beta1 = 0: for the Ds the R1 phase's,
  applied last, its double backward), leaf by leaf the gap between the
  two norms over the larger of the reference's norm of that leaf and of
  the median leaf; the median leaf's gap;
- `change_median.<m>`, also for the G-EMA (`g_ema`): each parameter's
  change over the steps, by the same measure, over the leaves whose
  first-step gradient in the reference is at least a thousandth of the
  median leaf's (the others move under Adam by round-off alone; the EMA
  takes G's leaves);
- `rows_off`: rows of those batches whose real image is no person of the
  root, or a person another row holds (the loader's stage the check does
  not recompute: its random occlusions and erasures are drawn from one
  RandomState its threads share).

Each median comes with the worst leaf's gap, printed for a diagnosis. A
number that is not finite on the program's side reads inf.
"""

from __future__ import annotations

import contextlib
import statistics
import time
import types

import numpy as np
import torch

from .. import weights as seeded
from ..reference.data.preprocess import load_person
from ..reference.data.roots import as_root
from ..reference.train.steps import ReferenceTraining, build_models
from . import check
from . import trace as tr
from .flops import OpCounter
from .k1_launches import routed

MODULES = ("g", "d", "dp")
LOSSES = {"g": ("g_loss", "g_loss_finetune", "g_parsing", "g_l1", "g_vgg",
                "g_mask"),
          "r1": ("r1_penalty", "dp_r1_penalty")}
NEGLIGIBLE = 1e-3       # of the median leaf's first gradient


class Stop(Exception):
    """Raised from the wrapped step once the traced steps have run."""


def train_config(ctx):
    """TrainConfig's keyword arguments: the configuration's training numbers
    and the mix's loader."""
    return dict(ctx.config["train"], loader_impl=ctx.traffic["loader_impl"])


def loop_seed(ctx):
    """The seed the loop takes: its sampler and the dataset seed numpy
    RandomStates, which hold 32 bits."""
    return ctx.seed % 2 ** 32


def loop_generator(ctx):
    """A torch.Generator seeded as `training_loop` seeds its own on one
    card: (seed + 1) * world + rank."""
    return torch.Generator(device=ctx.device).manual_seed(loop_seed(ctx) + 1)


def seeded_weights(ctx):
    """{"g", "d", "dp", "vgg"}: state dicts drawn from the run's seed on its
    device in two draws, by each leaf's initialiser (`weights.py`)."""
    cfg = types.SimpleNamespace(**train_config(ctx))
    with torch.device("meta"):
        models = build_models(cfg)
    specs = [(f"{name}.{leaf}", shape, init)
             for name, module in models.items()
             for leaf, shape, init in seeded.init_specs(module)]
    flat = seeded.seeded_state(specs, ctx.seed, ctx.device)
    return {name: {k[len(name) + 1:]: v for k, v in flat.items()
                   if k.startswith(name + ".")} for name in models}


class Recorder:
    """Wraps the step the loop builds and answers the loop's progress and
    abort calls.

    The first `kept` calls keep a clone of their batch and whether they ran
    R1; after the first, each module's Adam moments are cloned, after the
    `kept`-th, its parameters and the G-EMA's. The window opens at the progress call of
    the `warmup_ticks`-th tick and closes at the first one `seconds` later
    or more; without a trace the loop is then aborted, with one the next
    `trace_steps` steps run under the profiler (each marked on the device
    where it starts, one more mark after the last) and the step after them
    raises `Stop`. Every call runs inside `bench.train_step`."""

    def __init__(self, ctx, batch_size):
        w = ctx.workload
        self.ctx, self.batch_size = ctx, batch_size
        self.kept, self.warmup = w["check"]["steps"], w["warmup_ticks"]
        self.trace_steps = w["trace_steps"] if ctx.trace else 0
        self.calls = self.ticks = 0
        self.batches, self.kinds, self.metrics = [], [], []
        self.first = self.after = None
        self.t_open = self.t_close = None
        self.tick_times = []
        self.step_open = self.step_close = None
        self.span, self.traced_kinds = None, []

    def factory(self, make_train_step):
        """`make_train_step` with its step wrapped."""
        def make(cfg, vgg=None):
            real = make_train_step(cfg, vgg)

            def step(state, batch, generator, **kw):
                return self.step(real, state, batch, generator, **kw)
            return step
        return make

    def step(self, real, state, batch, generator, **kw):
        k = self.calls
        self.calls += 1
        if k < self.kept:
            self.batches.append({n: t.clone() for n, t in batch.items()})
            self.kinds.append(bool(kw.get("do_r1_d")))
        if self.t_close is not None and self.trace_steps:
            if len(self.traced_kinds) == self.trace_steps:
                raise Stop
            if self.span is None:
                self.span = tr.Span().__enter__()
            tr.mark()
            self.traced_kinds.append(bool(kw.get("do_r1_d")))
        with tr.label("train_step"):
            state, metrics = real(state, batch, generator, **kw)
        self.metrics.append(metrics)
        if k == 0:
            self.first = self._clone(state, lambda opt, p: opt.state.get(
                p, {}).get("exp_avg", torch.zeros_like(p)))
        if k == self.kept - 1:
            self.after = self._clone(state, lambda opt, p: p)
            self.after["g_ema"] = {n: p.detach().clone() for n, p in
                                   state.g_ema.named_parameters()}
        if len(self.traced_kinds) == self.trace_steps and self.span:
            tr.mark()
            self.span.__exit__(None, None, None)
        return state, metrics

    @staticmethod
    def _clone(state, what):
        from pasta_tpu_torch.train.state import trained_named_params

        out = {}
        for m in MODULES:
            opt = getattr(state, f"{m}_opt")
            out[m] = {n: what(opt, p).detach().clone() for n, p in
                      trained_named_params(opt, getattr(state, m))}
        return out

    def progress(self, nimg, total):
        now = time.perf_counter()
        self.ticks += 1
        self.tick_times.append(now)
        if self.ticks == self.warmup:
            self.t_open, self.step_open = now, nimg // self.batch_size
            self.ctx.stamp("warm-up")
        elif (self.t_open is not None and self.t_close is None
              and now - self.t_open >= self.ctx.seconds):
            self.t_close, self.step_close = now, nimg // self.batch_size

    def side(self, weights):
        """The program's side of the check: the kept steps' losses, the
        Adam moments after the first, the parameters before (`weights`)
        and after."""
        start = {m: weights[m] for m in MODULES}
        start["g_ema"] = weights["g"]
        return types.SimpleNamespace(
            losses=losses(self.metrics[:self.kept]), first=self.first,
            start=start, after=self.after)

    def abort(self):
        return self.t_close is not None and not self.trace_steps

    def window(self, tick_interval):
        """(seconds, steps, ticks attempted, ticks whose fetched losses are
        not all finite) of the window, and each tick's seconds."""
        steps = self.step_close - self.step_open
        failed = 0
        for t in range(self.step_open, self.step_close, tick_interval):
            values = [v.float() for m in self.metrics[t:t + tick_interval]
                      for v in m.values() if torch.is_tensor(v)]
            failed += not bool(torch.isfinite(torch.stack(values)).all())
        ticks = [b - a for a, b in zip(self.tick_times, self.tick_times[1:])
                 if self.t_open <= a and b <= self.t_close]
        return (self.t_close - self.t_open, steps, steps // tick_interval,
                failed, ticks)


def losses(metrics):
    """A step's metrics as numbers, step by step."""
    return [{k: float(v) for k, v in m.items()} for m in metrics]


def _norms(leaves):
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in leaves.items()}


def _leaf_gaps(got, want, leaves):
    """{leaf: |norm got - norm want| over the larger of norm want and the
    median leaf's norm want} (inf where got is not finite)."""
    med = statistics.median(want[n] for n in leaves)
    out = {}
    for n in leaves:
        scale, gap = max(want[n], med), abs(got[n] - want[n])
        out[n] = (float("inf") if not np.isfinite(got[n]) else
                  gap / scale if scale > 0 else
                  0.0 if gap == 0 else float("inf"))
    return out


def _loss_gap(program, reference, keys):
    """(the worst |program - reference| / |reference| of the first step's
    `keys`, where it lies)."""
    gap, at = 0.0, None
    got, want = program.losses[0], reference.losses[0]
    for key in keys:
        g, w = got.get(key, 0.0), want.get(key, 0.0)
        if not np.isfinite(g) or (w == 0 and g != 0):
            this = float("inf")
        else:
            this = abs(g - w) / abs(w) if w != 0 else 0.0
        if this > gap:
            gap, at = this, f"step 1 {key} {g!r} / {w!r}"
    return gap, at


def compare(program, reference, first_grad):
    """({number: value}, {number: where the worst reading lies}) of two
    sides (module docstring), each with `losses` ([per step {name:
    value}]), `first` ({m: {leaf: exp_avg}}), `start` and `after` ({m:
    {leaf: parameter}}, `after` also for "g_ema"); `first_grad`: {m:
    {leaf: the largest norm of the reference's first-step gradients}}."""
    out, where = {}, {}
    for m, keys in LOSSES.items():
        out[f"first_loss_gap.{m}"], where[f"first_loss_gap.{m}"] = \
            _loss_gap(program, reference, keys)
    moved = {}
    for m in MODULES:
        med = statistics.median(first_grad[m].values())
        moved[m] = [n for n, v in first_grad[m].items()
                    if v >= NEGLIGIBLE * med]
    groups = [("grad", m, list(first_grad[m])) for m in MODULES]
    groups += [("change", m, moved[m]) for m in MODULES]
    groups.append(("change", "g_ema", moved["g"]))
    for kind, m, leaves in groups:
        if kind == "grad":
            got, want = (_norms({n: side.first[m][n] for n in leaves})
                         for side in (program, reference))
        else:
            got, want = (_norms({n: side.after[m][n] - side.start[m][n]
                                 for n in leaves})
                         for side in (program, reference))
        gaps = _leaf_gaps(got, want, leaves)
        leaf = max(gaps, key=gaps.get)
        name = f"{kind}_median.{m}"
        out[name] = statistics.median(gaps.values())
        where[name] = (f"worst leaf {leaf} {gaps[leaf]!r}: "
                       f"{got[leaf]!r} / {want[leaf]!r}")
    return out, where


def rows_off(batches, root, resolution):
    """Rows of `batches` whose real image is no person of the root or one
    an earlier row holds."""
    import cv2

    data = as_root(root)
    persons = []
    for name in data.list("image"):
        img = load_person(data, name).image.astype(np.float32)
        if resolution != img.shape[0]:
            img = np.round(cv2.resize(img, (resolution, resolution),
                                      interpolation=cv2.INTER_AREA))
        persons.append(torch.from_numpy(img))
    seen, off = set(), 0
    for batch in batches:
        # the loader's 8-bit values back (the card divides by 127.5 as a
        # product with its reciprocal: an ulp off numpy's quotient)
        for row in torch.round((batch["real_img"].cpu() + 1) * 127.5):
            hit = [i for i, p in enumerate(persons) if torch.equal(row, p)]
            off += not hit or hit[0] in seen
            seen.update(hit[:1])
    return off


class Side:
    """One side of the comparison run as the reference: its losses, the
    first step's Adam moments, its parameters before and after (and the
    G-EMA's after). With `counting`, the operations of the first step of
    each kind (`ops`, by `do_r1`), with K1's convolutions made as the port
    launches them (`lib/k1_launches.py`)."""

    def __init__(self, ctx, weights, batches, kinds, tf32=False, rows=None,
                 counting=False):
        cfg = types.SimpleNamespace(**train_config(ctx))
        ref = ReferenceTraining(cfg, weights, ctx.device)
        self.start = {m: {n: p.detach().clone()
                          for n, p in ref.opt[m].named} for m in MODULES}
        self.start["g_ema"] = self.start["g"]
        self.first_grad = {m: {} for m in MODULES}

        def record(m, leaf, g):
            norm = float(torch.linalg.vector_norm(g.float()))
            self.first_grad[m][leaf] = max(self.first_grad[m].get(leaf, 0.0),
                                           norm)

        generator = loop_generator(ctx)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        metrics, self.ops = [], {}
        launches = routed() if counting else contextlib.nullcontext()
        try:
            with launches:
                for i, (batch, do_r1) in enumerate(zip(batches, kinds)):
                    if rows is not None:
                        batch = {k: v[:rows] for k, v in batch.items()}
                    ref.record = record if i == 0 else None
                    counter = contextlib.nullcontext()
                    if counting and do_r1 not in self.ops:
                        counter = self.ops[do_r1] = OpCounter()
                    with counter:
                        metrics.append(ref.step(batch, generator, do_r1))
                    if i == 0:
                        self.first = {m: {n: t.clone() for n, t in
                                          ref.opt[m].exp_avg.items()}
                                      for m in MODULES}
        finally:
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cuda.matmul.allow_tf32 = flags
        self.losses = losses(metrics)
        self.after = {m: {n: p.detach().clone()
                          for n, p in ref.opt[m].named} for m in MODULES}
        self.after["g_ema"] = {n: p.detach().clone()
                               for n, p in ref.g_ema.named_parameters()}


def check_steps(ctx, run, program, weights, batches, kinds, root,
                resolution):
    """Judge the program's first steps (`program`: `losses`, `first`,
    `start`, `after`, as a `Side` has them) against the reference's on the
    same batches, and the batches' rows: `run.numbers`. With a trace the
    reference's first R1 step and first regular step are counted
    afterwards, in a pass of their own (`run.ops_kinds`, by do_r1). With
    `ctx.control` the reference stands in for the program: at TF32
    ("tf32", or any other true value), or on the first half of each batch
    ("half_batch")."""
    reference = Side(ctx, weights, batches, kinds)
    if ctx.control:
        half = ctx.control == "half_batch"
        program = Side(ctx, weights, batches, kinds, tf32=not half,
                       rows=batches[0]["real_img"].shape[0] // 2 if half
                       else None)
    numbers, where = compare(program, reference, reference.first_grad)
    numbers["rows_off"] = rows_off(batches, root, resolution)
    del reference, program
    run.ops_kinds = {}
    if ctx.trace:
        run.ops_kinds = Side(ctx, weights, batches[:2], kinds[:2],
                             counting=True).ops
    run.notes.append("check numbers: " + ", ".join(
        f"{k} {v!r}" + (f" ({where[k]})" if where.get(k) else "")
        for k, v in numbers.items()))
    run.numbers = check.judge(numbers, ctx.workload["check"]["limits"])


def idle_note(span):
    """The traced window's idle ms, inside the `train_step` labels and
    between them, a step."""
    from .program import Idle

    marks = [s for name, s, _ in span.kernels if tr.MARK_KERNEL in name]
    lo, hi = marks[0], marks[-1]
    idle = Idle(span.kernels, lo, hi)
    total = sum(e - s for s, e in idle.pieces)
    inside = sum(idle.within(max(a, lo), min(b, hi))
                 for name, a, b in span.labels
                 if name == "train_step" and b > lo and a < hi)
    n = max(len(marks) - 1, 1)
    return (f"idle split, ms a step over {n} traced steps: inside "
            f"train_step {inside / 1e3 / n:.3f}; between steps "
            f"{(total - inside) / 1e3 / n:.3f}")
