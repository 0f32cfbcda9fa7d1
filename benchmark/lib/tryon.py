"""What the try-on drivers share: the set-up of the port's pipeline with
seeded weights over a seeded synthetic root, the sample of answers the
window keeps, and the check of that sample against the plain reference.
"""

from __future__ import annotations

import concurrent.futures
import gc
import os

import numpy as np
import torch

from .. import weights
from ..reference import tryon as reference
from ..reference.models.generator import Generator as ReferenceGenerator
from ..traffic import synth
from . import check
from .flops import OpCounter


class Reservoir:
    """A uniform sample of `size` of the answers offered, drawn from the
    seed whatever their number (reservoir sampling)."""

    def __init__(self, size, seed):
        self.size, self.seen, self.kept = size, 0, []
        self._rng = np.random.default_rng([seed, 2])

    def offer(self, pair, image):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((pair, np.array(image)))
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = (pair, np.array(image))


def seeded_weights(ctx):
    """The generator's weights of the run's seed, on its device."""
    with torch.device("meta"):
        specs = weights.init_specs(
            ReferenceGenerator(seed=None, **ctx.config["generator"]))
    return weights.seeded_state(specs, ctx.seed, ctx.device,
                                ctx.config["weights"].get("overrides"))


def build(ctx):
    """(pipeline, root directory, pairs, weights): the synthetic root is
    written on a thread while the generator is built."""
    from pasta_tpu_torch.models import Generator
    from pasta_tpu_torch.serving import TryonPipeline

    tr = ctx.traffic
    root = os.path.join(ctx.tmp, "root")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        names = pool.submit(synth.write_root, root, ctx.seed, tr["persons"],
                            tr["jitter_px"])
        ctx.stamp("imports")
        state = seeded_weights(ctx)
        ctx.stamp("weights")
        model = Generator(**ctx.config["generator"]).to(ctx.device)
        model.load_state_dict(state)
        pipe = TryonPipeline(model.eval(), **ctx.config["serving"])
        ctx.stamp("generator")
        pairs = synth.draw_pairs(names.result(), ctx.seed, tr["pairs"])
        ctx.stamp("root")
    return pipe, root, pairs, state


def read_peak(run):
    """The device's peak memory of the program, read before the reference
    runs (a process's peak never falls again)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated()


def release():
    """Return what the program's dropped state held to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_sample(ctx, run, root, state, sample, batch):
    """Compare the kept answers with the reference's images of the same
    pairs, `batch` at a time; the first block's forward is counted
    (`run.ops` over `run.ops_items` images). With `ctx.control` the
    reference at TF32 stands in for the program's answers."""
    ref = reference.ReferenceTryon(ctx.config["generator"], state,
                                   ctx.device, **ctx.config["serving"])
    data = reference.as_root(root)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        items = list(pool.map(
            lambda p: reference.prepare_pair(
                data, p, ctx.config["serving"]["mode"],
                ctx.config["serving"]["cond"]),
            [pair for pair, _ in sample]))
    gaps = []
    for i in range(0, len(sample), batch):
        block = items[i:i + batch]
        inputs = ref.inputs(block)
        if run.ops is None and len(block) == batch:
            run.ops, run.ops_items = OpCounter(), len(block)
            with run.ops:
                want = ref.forward(inputs)
        else:
            want = ref.forward(inputs)
        got = ([a for _, a in sample[i:i + batch]] if not ctx.control
               else ref.images(block, tf32=True))
        for g, w in zip(got, want):
            gaps.append(check.image_gaps(g, w))
            run.failed += not bool(torch.isfinite(torch.as_tensor(g)).all())
    run.numbers = check.judge(check.worst(gaps),
                              ctx.workload["check"]["limits"])
