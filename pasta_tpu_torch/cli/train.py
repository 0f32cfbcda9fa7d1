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

The training options follow the JAX CLI: --pl_weight (Gpl),
--contextual_weight, --grad-accum, --strict-phase-noise and
--reuse-g-fakes (true implies --strict-phase-noise false). The contextual
loss runs on the same VGG19 as the perceptual loss.

More than one GPU (train/entry.py; --batch stays the global batch):
--devices N (--gpus N) spawns N processes on this host, one card each
(NCCL), meeting through a file:// rendezvous in the run directory, as
the reference's train.py spawned its GPUs; fewer than N cards raise.
--device cpu --devices N runs N gloo processes on the CPU. --coordinator
host:port --num-processes P --process-id i makes this process rank i of P
single-card processes meeting at tcp://host:port (the JAX CLI's
multi-host bootstrap); process 0 writes the run directory.

In-training metrics (train/loop.py::TrainingEvaluator): --metrics
fid,kid,fid_tryon (or 'none') every --metric-ticks ticks over a held-out
pool of --metric-items items (default the config's metric_items, 512) that
the sampler skips, with the InceptionV3 weights of --inception (required
with --metrics; torchvision keys, .npz or .pth); --metric-cache DIR caches
the held-out reals' detector stats (the JAX CLI defaults it to
~/.cache/pasta_tpu/metrics; here there is no cache unless asked for). The
results go into stats.jsonl and the status lines.

Flags of options the port has not got yet are accepted and raise
NotImplementedError with the option's name when set off their default:
--tryon-grid, --trace. The JAX CLI's --step-mode, --remat*,
--d-remat, --vgg-remat and --ada-impl steer its TPU program and are not
flags here.
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
    p.add_argument("--devices", "--gpus", type=int, default=1, dest="devices",
                   help="processes to spawn on this host, one card each")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0: this process is one rank "
                        "of --num-processes (one card each)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
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
    p.add_argument("--metrics", default="none",
                   help="comma-separated in-training metrics "
                        "(fid,kid,fid_tryon) or 'none'; evaluated on a "
                        "held-out set excluded from training")
    p.add_argument("--metric-ticks", type=int, default=10,
                   help="evaluate metrics every N ticks")
    p.add_argument("--metric-items", type=int, default=None,
                   help="held-out set size for metrics (these items are "
                        "excluded from the training sampler); default "
                        "the config's metric_items (512)")
    p.add_argument("--metric-cache", default=None,
                   help="disk cache dir for the held-out reals' detector "
                        "stats; none by default ('none' too)")
    p.add_argument("--inception", default=None,
                   help="inception detector weights (.pth/.npz) for "
                        "metrics")
    p.add_argument("--tryon-grid", type=int, default=0, metavar="K")
    p.add_argument("--dry-run", action="store_true")
    return p.parse_args(argv)


def eval_metrics_of(args):
    """The in-training metrics --metrics asks for; they need --inception."""
    metrics = tuple(m for m in args.metrics.split(",") if m and m != "none")
    for m in metrics:
        if m not in ("fid", "kid", "fid_tryon"):
            raise ValueError(f"--metrics: unsupported in-training metric {m!r}"
                             " (fid, kid, fid_tryon)")
    if metrics and args.inception is None:
        raise ValueError("--metrics needs --inception (the InceptionV3 "
                         "weights)")
    return metrics


def _refuse_deferred(args):
    """Loop-level options the port has not got yet (the TrainConfig ones
    raise from TrainConfig.__post_init__ with their own names)."""
    if args.tryon_grid != 0:
        raise NotImplementedError(
            f"--tryon-grid {args.tryon_grid}: the cross-pair grid is not "
            "ported yet (only 0)")
    if args.trace is not None:
        raise NotImplementedError(
            "--trace: not ported yet (cli/bench_train.py --profile traces "
            "a step)")


def world_of(args):
    """The number of ranks the flags ask for."""
    if args.coordinator is None:
        return args.devices
    if args.devices != 1:
        raise ValueError("--coordinator runs one card a process: "
                         "--devices must stay 1")
    if args.num_processes is None or args.process_id is None \
            or not 0 <= args.process_id < args.num_processes:
        raise ValueError("--coordinator needs --num-processes P and "
                         "--process-id in [0, P)")
    return args.num_processes


def build_config(args):
    from ..train.config import TrainConfig, smoke_config

    _refuse_deferred(args)
    eval_metrics_of(args)
    world = world_of(args)
    if args.cfg == "smoke":
        cfg = smoke_config(world)
    else:
        cfg = TrainConfig(data_axis_size=world)
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
    from ..ops._build import pin_fp32_numerics

    numerics = pin_fp32_numerics()
    args = parse_args(argv)
    cfg = build_config(args)

    if not args.dry_run and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "pasta_tpu_torch.cli.train: needs an NVIDIA GPU "
                "(pass --device cpu to train on the CPU)")
        if torch.cuda.device_count() < args.devices:
            raise SystemExit(
                f"pasta_tpu_torch.cli.train: --devices {args.devices} needs "
                f"{args.devices} CUDA devices, {torch.cuda.device_count()} "
                "found")

    run_dir = None
    if args.coordinator is None or args.process_id == 0:
        run_dir = next_run_dir(
            args.outdir,
            f"{args.cfg}-b{cfg.batch_size}-d{cfg.data_axis_size}")
        with open(os.path.join(run_dir, "training_options.json"), "w") as f:
            json.dump({**dataclasses.asdict(cfg), "args": vars(args),
                       "numerics": numerics}, f, indent=2)
        print(f"run dir: {run_dir}")
        print(json.dumps(dataclasses.asdict(cfg), indent=2))

    if args.dry_run:
        print("dry run: config OK, exiting")
        return None

    if args.coordinator is not None:
        train_rank(args.process_id, args.num_processes, args, cfg, run_dir,
                   f"tcp://{args.coordinator}", 1)
    elif args.devices > 1:
        from ..train.entry import spawn

        rendezvous = os.path.join(run_dir, ".rendezvous")
        try:
            spawn(train_rank, args.devices, args, cfg, run_dir,
                  "file://" + rendezvous, None)
        finally:
            if os.path.exists(rendezvous):
                os.remove(rendezvous)
    else:
        train(args, cfg, run_dir, args.device)
    return run_dir


def train_rank(rank, world, args, cfg, run_dir, init_method, local_world):
    """One rank of a data-parallel run: joins the process group (its own
    card, or gloo on the CPU), trains, leaves."""
    import torch.distributed as dist

    from ..train.entry import init_distributed

    device = init_distributed(rank, world, init_method, args.device,
                              local_world=local_world)
    try:
        train(args, cfg, run_dir, device)
    finally:
        dist.destroy_process_group()


def train(args, cfg, run_dir, device):
    """The dataset, the VGG19, the metrics' detector and the training loop
    on `device`."""
    from ..data.trainsets import TryonTrainDataset
    from ..train.dist import rank
    from ..train.loop import training_loop

    chief = rank() == 0
    dataset = TryonTrainDataset(args.data, seed=args.seed,
                                resolution=cfg.resolution,
                                loader_impl=cfg.loader_impl,
                                max_size=args.subset,
                                xflip=bool(args.mirror),
                                random_seed=args.seed)
    if chief:
        print(f"dataset: {len(dataset)} images from {args.data}")
    vgg = None
    if cfg.vgg_weight > 0 or cfg.contextual_weight > 0:
        vgg = load_vgg_params(args.vgg19, seed=args.seed).to(device)
        if args.vgg19 is None and chief:
            print("WARNING: no --vgg19 weights; the VGG and contextual "
                  "losses run on seeded random weights")
    eval_metrics = eval_metrics_of(args)
    detector = None
    if eval_metrics and chief:
        from ..metrics.metric_main import load_detector

        detector = load_detector(args.inception, device)
    training_loop(cfg, dataset, run_dir, vgg=vgg, resume_path=args.resume,
                  total_steps=args.max_steps, tick_interval=args.tick,
                  num_workers=args.workers, snapshot_ticks=args.snap,
                  seed=args.seed, device=device, eval_metrics=eval_metrics,
                  eval_ticks=args.metric_ticks, eval_items=args.metric_items,
                  detector=detector,
                  metric_cache_dir=(None if args.metric_cache in (None, "none")
                                    else os.path.expanduser(args.metric_cache)))


if __name__ == "__main__":
    main()
