"""Find the highest rate the single-request path sustains: serve the
cell's requests at each offered rate in turn, in one process on the card,
and print each rate's latency percentiles and how late the server started
its requests early and late in the run (a growing lateness is a growing
backlog). The cells fix their rate from this once; a run never searches.

    python3 -m benchmark.sweep --workload g512_fp32_single_b1 \\
        --seed 1 --seconds 15 --rates 6 7 8 9 10
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time

T_START = time.perf_counter()


def main(argv=None):
    from . import harness
    from .drivers import single
    from .lib import stats, tryon

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="g512_fp32_single_b1")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    harness.pin_caches()
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        ctx = harness.Context(args.workload, args.seed, args.seconds, False,
                              "cuda", T_START, tmp)
        pipe, root, pairs, _ = tryon.build(ctx)
        requests = iter(pairs)
        for _ in range(ctx.workload["warmup_requests"]):
            single._request(pipe, root, next(requests))
        for rate in args.rates:
            spans = collections.defaultdict(list)
            single.serve(pipe, root, requests, rate, args.seconds, spans)
            late = [1e3 * s for s in spans["lateness"]]
            q = max(len(late) // 4, 1)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(late),
                "p50_ms": stats.percentile(
                    [1e3 * s for s in spans["latency"]], 50),
                "p90_ms": stats.percentile(
                    [1e3 * s for s in spans["latency"]], 90),
                "lateness_first_quarter_ms": stats.median(late[:q]),
                "lateness_last_quarter_ms": stats.median(late[-q:])}),
                flush=True)


if __name__ == "__main__":
    main()
