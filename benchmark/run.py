"""Run one cell of the benchmark of pasta_tpu_torch on the card(s) of this
machine and print its result as the last line of standard output:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, the device's busy and window seconds
and the breakdown of a traced span. The numbers compared with the plain
reference come last, each beside its limit, on standard error too.
Exits 2 without a result where the cell's cards are missing, 3 where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import harness  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device_record(run, trace, chips):
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": run.memory_peak}
    if trace:
        rec.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    return rec


def main(argv=None):
    args = _args(argv)
    bench = harness.declared()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[args.workload]
    harness.pin_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(2)
    from pasta_tpu_torch.ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        ctx = harness.Context(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, tmp)
        run = harness.driver(ctx).run(ctx)
    metrics = harness.metric_values(ctx, run, bench)
    correct, checks = run.numbers
    found = harness.loaded_forbidden()
    if found:
        print(f"benchmark: loaded {', '.join(found)}", file=sys.stderr)
        sys.exit(3)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": _device_record(run, args.trace, chips)}
    if args.trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    ctx.stamp("check")
    for line in run.notes:
        print(line, file=sys.stderr)
    print("set-up: " + ", ".join(f"{w} {t:.2f} s" for w, t in ctx.stamps),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
