"""Training CLI, port of pasta_tpu/cli/train.py; the flag surface mirrors
the reference train.py.

    python3 -m pasta_tpu_torch.cli.train --outdir runs --data <dir or .zip> \\
        --cfg fashion --batch 4 --l1weight 10 --vgg_weight 20 --mask_weight 30

Runs on the card; `--device cpu` asks for the CPU (the tests do), and
without a card and without that flag the command refuses to run.
--dry-run constructs the full config without training (train.py:434,
551-553). training_options.json is written like the reference
(train.py:558-559). Without --vgg19 the perceptual loss runs on a seeded
random VGG19, since no weights can be fetched.

Flags of options the port has not got yet are accepted and raise
NotImplementedError with the option's name when set off their default:
--devices / --gpus above 1, --pl_weight, --contextual_weight,
--grad-accum, --reuse-g-fakes, --strict-phase-noise, --metrics,
--tryon-grid, --trace. The JAX CLI's --step-mode, --remat*, --d-remat,
--vgg-remat, --ada-impl, --coordinator, --num-processes and --process-id
steer its TPU program and are not flags here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re


def _strict_bool(s):
    """Boolean flag parser that rejects unknown spellings (the reference
    accepts e.g. --flag=true via click's BOOL; a lambda s=="True" would
    silently read it as False)."""
    low = str(s).strip().lower()
    if low in ("true", "1", "yes", "y"):
        return True
    if low in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--outdir", required=True)
    p.add_argument("--data", required=True,
                   help="dataset root, directory or .zip (image/ keypoints/ "
                        "parsing/ garment_parsing/)")
    p.add_argument("--mirror", type=int, default=0,
                   help="augment dataset with x-flips (reference "
                        "train.py:44 --mirror)")
    p.add_argument("--subset", type=int, default=None,
                   help="train with only N images (reference train.py:43)")
    p.add_argument("--cfg", default="fashion", choices=["fashion", "smoke"])
    p.add_argument("--devices", "--gpus", type=int, default=1, dest="devices")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train: the card, or the CPU when asked")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--kimg", type=int, default=None)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--l1weight", type=float, default=10.0)
    p.add_argument("--vgg_weight", type=float, default=20.0)
    p.add_argument("--mask_weight", type=float, default=30.0)
    p.add_argument("--pl_weight", type=float, default=0.0)
    p.add_argument("--contextual_weight", type=float, default=0.0)
    p.add_argument("--use_noise_const_branch", type=_strict_bool,
                   default=True)
    p.add_argument("--aug", default="ada", choices=["ada", "noaug", "fixed"])
    p.add_argument("--p", type=float, default=0.0, help="fixed augment p")
    p.add_argument("--target", type=float, default=0.6)
    p.add_argument("--resume", default=None,
                   help="a ckpt-*.pt of this package, or a flat .npz "
                        "training state of either package")
    p.add_argument("--vgg19", default=None,
                   help="torchvision-format vgg19 .pth/.npz for the VGG loss")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--snap", type=int, default=10, help="snapshot ticks")
    p.add_argument("--tick", type=int, default=50,
                   help="steps between status lines / stats rows")
    p.add_argument("--max-steps", type=int, default=None,
                   help="hard step cap (smoke/debug)")
    p.add_argument("--d-bf16-res", type=int, default=3,
                   help="top-N D resolutions in bf16 (reference ships 3)")
    p.add_argument("--g-bf16-res", type=int, default=0,
                   help="top-N G synthesis resolutions in bf16 compute")
    p.add_argument("--reuse-g-fakes", type=_strict_bool, default=False)
    p.add_argument("--strict-phase-noise", type=_strict_bool, default=True)
    p.add_argument("--loader-impl", default="host",
                   choices=["host", "device"],
                   help="training data loader: 'device' runs per-sample "
                        "warps/rasters on the card (host keeps "
                        "decode + scalar geometry only)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatch accumulation rounds per step")
    p.add_argument("--trace", default=None)
    p.add_argument("--metrics", default="none")
    p.add_argument("--metric-ticks", type=int, default=10)
    p.add_argument("--metric-items", type=int, default=None)
    p.add_argument("--metric-cache", default=None)
    p.add_argument("--inception", default=None)
    p.add_argument("--tryon-grid", type=int, default=0, metavar="K")
    p.add_argument("--dry-run", action="store_true")
    return p.parse_args(argv)


def _refuse_deferred(args):
    """Loop-level options the port has not got yet (the TrainConfig ones
    raise from TrainConfig.__post_init__ with their own names)."""
    if args.metrics not in ("none", ""):
        raise NotImplementedError(
            f"--metrics {args.metrics!r}: the in-training evaluator is not "
            "ported yet (only 'none')")
    if args.tryon_grid != 0:
        raise NotImplementedError(
            f"--tryon-grid {args.tryon_grid}: the cross-pair grid is not "
            "ported yet (only 0)")
    if args.trace is not None:
        raise NotImplementedError(
            "--trace: not ported yet (cli/bench_train.py --profile traces "
            "a step)")


def build_config(args):
    from ..train.config import TrainConfig, smoke_config

    _refuse_deferred(args)
    if args.cfg == "smoke":
        cfg = smoke_config(args.devices)
    else:
        cfg = TrainConfig(data_axis_size=args.devices)
    updates = dict(
        l1_weight=args.l1weight,
        vgg_weight=args.vgg_weight,
        mask_weight=args.mask_weight,
        pl_weight=args.pl_weight,
        contextual_weight=args.contextual_weight,
        use_noise=args.use_noise_const_branch,
        ada_target=args.target,
        use_ada=args.aug != "noaug",
        augment_p_init=args.p if args.aug == "fixed" else 0.0,
        loader_impl=args.loader_impl,
        d_num_bf16_res=args.d_bf16_res,
        g_num_bf16_res=args.g_bf16_res,
        reuse_g_fakes=args.reuse_g_fakes,
        strict_phase_noise=(args.strict_phase_noise
                            and not args.reuse_g_fakes),
        grad_accum=args.grad_accum,
    )
    if args.batch is not None:
        updates["batch_size"] = args.batch
    if args.kimg is not None:
        updates["total_kimg"] = args.kimg
    if args.gamma is not None:
        updates["r1_gamma"] = args.gamma
    return dataclasses.replace(cfg, **updates)


def next_run_dir(outdir, desc):
    """NNNNN-<desc> auto-numbering (reference train.py:526-533)."""
    os.makedirs(outdir, exist_ok=True)
    prev = [re.match(r"^(\d+)-", d) for d in os.listdir(outdir)]
    prev_ids = [int(m.group(1)) for m in prev if m]
    run_id = max(prev_ids, default=-1) + 1
    run_dir = os.path.join(outdir, f"{run_id:05d}-{desc}")
    os.makedirs(run_dir)
    return run_dir


def load_vgg_params(path, seed=0):
    """The VGG19 feature extractor of the perceptual loss: torchvision
    weights from `path` (.pth or .npz of a state dict), or, with no path,
    seeded random weights (nothing can be fetched; the loss then measures
    distances in a random feature pyramid)."""
    import numpy as np
    import torch

    from ..losses.vgg import VGG19Features

    vgg = VGG19Features(seed=seed + 3).requires_grad_(False)
    if path is None:
        return vgg
    if path.endswith(".npz"):
        with np.load(path) as data:
            state = {k: torch.from_numpy(data[k]) for k in data.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    wanted = set(vgg.state_dict())
    vgg.load_state_dict({k: v for k, v in state.items() if k in wanted},
                        strict=True)
    return vgg


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)

    if not args.dry_run and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "pasta_tpu_torch.cli.train: needs an NVIDIA GPU "
                "(pass --device cpu to train on the CPU)")

    run_dir = next_run_dir(
        args.outdir, f"{args.cfg}-b{cfg.batch_size}-d{cfg.data_axis_size}")
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg), "args": vars(args)}, f, indent=2)
    print(f"run dir: {run_dir}")
    print(json.dumps(dataclasses.asdict(cfg), indent=2))

    if args.dry_run:
        print("dry run: config OK, exiting")
        return None

    from ..data.trainsets import TryonTrainDataset
    from ..train.loop import training_loop

    dataset = TryonTrainDataset(args.data, seed=args.seed,
                                resolution=cfg.resolution,
                                loader_impl=cfg.loader_impl,
                                max_size=args.subset,
                                xflip=bool(args.mirror),
                                random_seed=args.seed)
    print(f"dataset: {len(dataset)} images from {args.data}")
    vgg = None
    if cfg.vgg_weight > 0:
        vgg = load_vgg_params(args.vgg19, seed=args.seed).to(args.device)
        if args.vgg19 is None:
            print("WARNING: vgg_weight > 0 but no --vgg19 weights; the VGG "
                  "loss runs on seeded random weights")
    training_loop(cfg, dataset, run_dir, vgg=vgg, resume_path=args.resume,
                  total_steps=args.max_steps, tick_interval=args.tick,
                  num_workers=args.workers, snapshot_ticks=args.snap,
                  seed=args.seed, device=args.device)
    return run_dir


if __name__ == "__main__":
    main()
