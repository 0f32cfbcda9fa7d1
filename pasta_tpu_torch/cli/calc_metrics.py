"""Metric runner CLI, port of pasta_tpu/cli/calc_metrics.py (the reference
calc_metrics.py:87-95 flag surface, adapted to the folder-vs-folder
evaluation the try-on pipeline uses).

    python3 -m pasta_tpu_torch.cli.calc_metrics --metrics fid,kid \\
        --real <dir of real images> --gen <dir of generated composites> \\
        --detector inception.npz [--vgg16-detector vgg16.npz] \\
        [--crop-generated]

--crop-generated takes the generated panel (the right third of the
[clothes | person | generated] composite that cli/test.py writes) before
feature extraction. `ppl` synthesizes along the style interpolation path
instead of reading folders: it builds the fashion Generator, loads
--network as cli/test.py does (a JAX generator .npz or a cli.train
ckpt-N.pt; seeded random weights without it) and reads its condition
pairs from --dataroot / --testtxt.

--detector and --vgg16-detector take torchvision-keyed state dicts, flat
.npz or a torch .pth of tensors. Runs on the card; `--device cpu` asks for
the CPU (the tests do), and without a card and without that flag the
command refuses to run. One JSON line of results a metric.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--metrics", default="fid",
                   help="comma-separated: fid,kid,inception_score,pr,ppl")
    p.add_argument("--real", default=None,
                   help="dir of real images (unused by ppl)")
    p.add_argument("--gen", default=None,
                   help="dir of generated images (unused by ppl)")
    p.add_argument("--network", default=None,
                   help="[ppl] generator checkpoint (JAX .npz / cli.train "
                        "ckpt-N.pt; omit for seeded random weights)")
    p.add_argument("--dataroot", default=None,
                   help="[ppl] test data root with the condition pairs")
    p.add_argument("--testtxt", default="test_pairs.txt")
    p.add_argument("--testpart", default="upper",
                   choices=["upper", "lower", "full"])
    p.add_argument("--ppl-items", type=int, default=8,
                   help="[ppl] number of condition pairs to interpolate")
    p.add_argument("--detector", required=True,
                   help="inception_v3 weights (.npz or torch .pth)")
    p.add_argument("--vgg16-detector", default=None,
                   help="torchvision vgg16 weights; when given, `pr` uses "
                        "VGG16 fc7 features (the reference PR detector) "
                        "and `ppl` the LPIPS space")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--crop-generated", action="store_true",
                   help="use the right third of composite images as gen "
                        "input")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card, or the CPU when asked")
    return p.parse_args(argv)


def build_ppl_ctx(args, device):
    """The fashion Generator with --network's weights on `device`, and
    the PPL context over the first --ppl-items pairs of --testtxt."""
    from .. import models
    from ..metrics.ppl import build_tryon_ppl_ctx
    from .test import load_generator_weights

    with open(os.path.join(args.dataroot, args.testtxt)) as f:
        pairs = [ln.split() for ln in f if ln.strip()][:args.ppl_items]
    model = load_generator_weights(models.Generator(), args.network)
    model = model.eval().to(device)
    return build_tryon_ppl_ctx(model, args.dataroot, pairs, args.testpart)


def main(argv=None):
    """Run each metric of --metrics; returns their records."""
    from ..ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    args = parse_args(argv)
    import torch

    from ..metrics.metric_main import (
        DetectorRunner, calc_metric, is_valid_metric, list_metrics,
        load_detector, load_vgg16_detector)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pasta_tpu_torch.cli.calc_metrics: needs an NVIDIA "
                         "GPU (pass --device cpu to run on the CPU)")
    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    for m in metrics:
        if not is_valid_metric(m):
            raise SystemExit(f"unknown metric '{m}'; valid: {list_metrics()}")
    for m in metrics:
        if m != "ppl" and not (args.real and args.gen):
            raise SystemExit(f"--metrics {m} needs --real and --gen")
    if "ppl" in metrics and not args.dataroot:
        raise SystemExit("--metrics ppl needs --dataroot (+ --testtxt)")
    device = torch.device(args.device)
    runner = DetectorRunner(load_detector(args.detector, device), args.batch)
    vgg_runner = None
    if args.vgg16_detector:
        vgg_runner = DetectorRunner(
            load_vgg16_detector(args.vgg16_detector, device=device),
            args.batch, kind="vgg16")
    crop = None
    if args.crop_generated:
        crop = (0, 512, 640, 960)  # generated panel of the 960x512 composite
    ppl_ctx = build_ppl_ctx(args, device) if "ppl" in metrics else None

    records = []
    for m in metrics:
        if m == "ppl":
            record = calc_metric(
                m, vgg_runner if vgg_runner is not None else runner,
                args.real, args.gen, run_dir=args.run_dir, ppl_ctx=ppl_ctx,
                max_items=args.max_items)
        else:
            record = calc_metric(
                m, vgg_runner if (m == "pr" and vgg_runner is not None)
                else runner,
                args.real, args.gen, run_dir=args.run_dir,
                max_items=args.max_items, cache_dir=args.cache_dir, crop=crop)
        print(json.dumps(record["results"]), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
