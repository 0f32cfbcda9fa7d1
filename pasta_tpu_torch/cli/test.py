"""Try-on inference CLI, port of pasta_tpu/cli/test.py; the flag surface
mirrors the reference test.py.

    python3 -m pasta_tpu_torch.cli.test --network <ckpt> --dataroot <dir> \\
        --testtxt test_pairs.txt --testpart upper --batchsize 1 --outdir out

Writes one composite PNG per pair, `<person>___<clothes>.png`: the center
crop (cols 96:416) of [clothes | person | generated] side by side
(test.py:162-184). Runs on the card; `--device cpu` asks for the CPU (the
tests do), and without a card and without that flag the command refuses
to run.

--network: a generator `.npz` of the JAX package
(`pasta_tpu/io/npz_ckpt.py::save_npz_variables`), a `ckpt-N.pt` of
`pasta_tpu_torch.cli.train` (its G-EMA), or the reference's
`network-snapshot-*.pkl` (its G_ema; unpickling imports the reference tree
at $PASTA_REFERENCE_ROOT, io/legacy_pkl.py); without it, the port's seeded
random generator (a smoke of the data path). The JAX package's orbax
directories raise by name.

--pipeline parity: host preprocessing (`data/testsets.py`, the reference
data path) and the generator, the tail batch padded. --pipeline serving:
`TryonPipeline.run_stream` (device conditioning and warps, host prep of
later batches on threads while the card runs; its outputs equal
`run_batch`'s).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--network", default=None,
                   help="checkpoint: JAX generator .npz / cli.train ckpt-N.pt")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--testtxt", default="test_pairs.txt")
    p.add_argument("--testpart", default="upper",
                   choices=["upper", "lower", "full"])
    p.add_argument("--batchsize", type=int, default=1)
    p.add_argument("--outdir", default="test_results")
    p.add_argument("--use-sleeve-mask", dest="use_sleeve_mask",
                   action="store_true", default=True)
    p.add_argument("--no-sleeve-mask", dest="use_sleeve_mask",
                   action="store_false")
    p.add_argument("--g-bf16-res", type=int, default=0,
                   help="run the generator's top-N-resolution blocks in "
                        "bf16 (0 = fp32, the reference inference numerics)")
    p.add_argument("--noise-mode", default="const",
                   choices=["const", "random", "none"])
    p.add_argument("--pipeline", default="parity",
                   choices=["parity", "serving"],
                   help="'parity' = host preprocessing (bit-matches the "
                        "reference data path); 'serving' = TryonPipeline."
                        "run_stream (device conditioning + warps, host prep "
                        "overlapped with the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card, or the CPU when asked")
    return p.parse_args(argv)


def load_generator_weights(model, network_path):
    """Load a checkpoint into the port's `Generator` in place (no path:
    keep its seeded init). Returns the model."""
    if network_path is None:
        return model
    if os.path.isdir(network_path):
        raise NotImplementedError(
            f"--network {network_path}: an orbax directory of the JAX "
            "package; write it as a .npz with pasta_tpu.io.npz_ckpt."
            "save_npz_variables")
    if network_path.endswith(".pkl"):
        # the reference's snapshot; unpickling imports its source tree
        from ..io.legacy_pkl import load_reference_pickle_generator

        state = load_reference_pickle_generator(network_path)
    elif network_path.endswith(".npz"):
        from ..io.from_jax import load_npz

        state = load_npz(network_path)
    elif network_path.endswith(".pt"):
        from ..io.checkpoint import load_module

        state = load_module(network_path, "g_ema")
    else:
        raise ValueError(f"--network {network_path}: not a .npz, .pt or "
                         ".pkl")
    model.load_state_dict(state, strict=True)
    return model


def _write_composites(outdir, gen, person_imgs, clothes_imgs, person_names,
                      clothes_names):
    """[clothes | person | generated] center-crop composites
    (test.py:162-184 layout, RGB->BGR files)."""
    import cv2

    for i in range(len(person_names)):
        gen_img = np.clip((gen[i] + 1) * 127.5, 0, 255).astype(np.uint8)
        result = np.concatenate(
            [clothes_imgs[i][:, 96:416], person_imgs[i][:, 96:416],
             gen_img[:, 96:416]], axis=1)
        person_n = os.path.basename(person_names[i])
        clothes_n = os.path.basename(clothes_names[i])
        save_name = f"{person_n[:-4]}___{clothes_n[:-4]}.png"
        cv2.imwrite(os.path.join(outdir, save_name), result[..., ::-1])


def _run_serving(args, dataset, model):
    """Production-path inference: TryonPipeline.run_stream (device
    conditioning + warps, host prep on threads while the card runs)."""
    from ..serving import TryonPipeline

    pipe = TryonPipeline(model, mode=args.testpart,
                         noise_mode=args.noise_mode, cond="device",
                         seed=args.seed)
    n_done = 0
    for pairs, gen, images in pipe.run_stream(
            dataset.root, dataset.pairs, batch_size=args.batchsize,
            use_sleeve_mask=args.use_sleeve_mask, with_images=True):
        _write_composites(
            args.outdir, gen, [p for p, _ in images], [c for _, c in images],
            [pn for pn, _ in pairs], [cn for _, cn in pairs])
        n_done += len(pairs)
    return n_done


def _run_parity(args, dataset, model, device):
    """Host preprocessing + the generator, batch by batch."""
    import torch

    from ..data.testsets import to_model_inputs
    from ..serving import NoiseSeeds

    noise = NoiseSeeds(args.seed, device)
    n_done = 0
    for start in range(0, len(dataset), args.batchsize):
        items = [dataset[i] for i in
                 range(start, min(start + args.batchsize, len(dataset)))]
        # one batch shape: the tail batch padded
        n_real = len(items)
        while len(items) < args.batchsize:
            items.append(items[-1])
        inputs, extras = to_model_inputs(items)
        inputs = {k: torch.from_numpy(v).to(device)
                  for k, v in inputs.items()}
        generator = noise.next() if args.noise_mode == "random" else None
        with torch.inference_mode():
            _, finetune, _ = model(noise_mode=args.noise_mode,
                                   generator=generator, **inputs)
        gen = finetune.float().cpu().numpy()
        _write_composites(
            args.outdir, gen,
            [((extras["image"][i] + 1) * 127.5).astype(np.uint8)
             for i in range(n_real)],
            [((extras["clothes"][i] + 1) * 127.5).astype(np.uint8)
             for i in range(n_real)],
            extras["person_names"][:n_real], extras["clothes_names"][:n_real])
        n_done += n_real
    return n_done


def main(argv=None):
    """Run the try-on over the pairs file; returns the number of
    composites written."""
    from ..ops._build import pin_fp32_numerics

    pin_fp32_numerics()
    args = parse_args(argv)
    import torch

    from .. import models
    from ..data.testsets import TryonPairDataset

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pasta_tpu_torch.cli.test: needs an NVIDIA GPU "
                         "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    dataset = TryonPairDataset(
        args.dataroot, args.testtxt, mode=args.testpart,
        use_sleeve_mask=args.use_sleeve_mask)
    print(f"{len(dataset)} pairs, part={args.testpart}, "
          f"pipeline={args.pipeline}, device={device}")

    model = models.Generator(num_bf16_res=args.g_bf16_res)
    model = load_generator_weights(model, args.network).eval().to(device)
    t0 = time.time()
    if args.pipeline == "serving":
        n_done = _run_serving(args, dataset, model)
    else:
        n_done = _run_parity(args, dataset, model, device)
    dt = time.time() - t0
    print(f"finished: {n_done} images -> {args.outdir} "
          f"({n_done / max(dt, 1e-9):.2f} img/s incl. preprocessing)")
    return n_done


if __name__ == "__main__":
    main()
