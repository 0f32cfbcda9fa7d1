"""The command line's training run over 2 gloo ranks on the CPU
(`cli.train.main(["--device", "cpu", "--devices", "2", ...])`): a
synthetic dataset root, the smoke config (64 px, global batch 4, 2 a
rank), no noise and ADA at p = 0 (nothing random matters), one loader
thread a rank (the only setting with a repeatable stream of draws), two
steps, then a resume for a third.

Held: only rank 0 writes (the run directory holds one rank's files, no
sample grid, the rendezvous file gone); the loaders' index streams are
disjoint and together the one-rank stream; stats.jsonl's first row is the
global batch's (step 0, R1 included, recomputed over 2 ranks from the
loaders' batches, 1e-5 relative: the same operations on the same inputs),
not rank 0's alone; every rank resumes bit-equal to the checkpoint.
"""

import os

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from pasta_tpu_torch.cli import train as cli
from pasta_tpu_torch.data.synthetic import write_dataset_root
from pasta_tpu_torch.data.trainsets import (TryonTrainDataset,
                                            assemble_train_batch)
from pasta_tpu_torch.train import loop as ploop
from pasta_tpu_torch.train import state as pstate
from pasta_tpu_torch.train.steps import fetch_metrics, make_train_step
from test_torch_loop import _rows

WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_loop")
    data = str(tmp / "root")
    write_dataset_root(data, 6, 90)
    common = ["--outdir", str(tmp / "runs"), "--data", data, "--cfg",
              "smoke", "--device", "cpu", "--devices", str(WORLD),
              "--vgg_weight", "0", "--workers", "1", "--tick", "1", "--snap",
              "100", "--use_noise_const_branch", "false"]
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")       # each rank one thread
    try:
        first = cli.main(common + ["--max-steps", "2"])
        again = cli.main(common + ["--max-steps", "3", "--resume",
                                   os.path.join(first, "ckpt-000002.pt")])
    finally:
        mp.undo()
    return dict(tmp=tmp, data=data, common=common, first=first, again=again,
                cfg=cli.build_config(cli.parse_args(common)))


def test_only_rank_0_writes(run):
    assert sorted(os.listdir(run["tmp"] / "runs")) == sorted(
        os.path.basename(r) for r in (run["first"], run["again"]))
    for r, ckpt in ((run["first"], "ckpt-000002.pt"),
                    (run["again"], "ckpt-000003.pt")):
        names = sorted(n for n in os.listdir(r) if not n.startswith("events"))
        # no sample grid with ranks (each holds only its rows)
        assert names == [ckpt, "log.txt", "stats.jsonl",
                         "training_options.json"]
    log = open(os.path.join(run["first"], "log.txt")).read()
    assert log.count("tick step 1 ") == 1
    assert [r["step"] for r in _rows(run["first"])] == [1, 2]
    assert [r["step"] for r in _rows(run["again"])] == [3]
    assert os.path.basename(run["first"]).endswith("-smoke-b4-d2")


def _dataset(run):
    return TryonTrainDataset(run["data"], seed=0, resolution=64,
                             loader_impl="host", random_seed=0)


def test_loaders_take_disjoint_shares_of_one_stream(run):
    n = len(_dataset(run))
    streams = []
    for r in range(WORLD):
        loader = ploop.ParallelLoader(_dataset(run), 2, 1, 0, rank=r,
                                      num_replicas=WORLD)
        streams.append([next(loader.sampler) for _ in range(n // WORLD)])
        loader.close()
    one = ploop.ParallelLoader(_dataset(run), 4, 1, 0)
    whole = [next(one.sampler) for _ in range(n)]
    one.close()
    assert not set(streams[0]) & set(streams[1])
    assert whole == [streams[i % WORLD][i // WORLD] for i in range(n)]


def _first_batches(run):
    """Each rank's first batch as the loop builds it (one loader thread:
    the same draws in the same order)."""
    out = []
    for r in range(WORLD):
        loader = ploop.ParallelLoader(_dataset(run), 2, 1, 0, rank=r,
                                      num_replicas=WORLD)
        loaded = next(iter(loader))
        loader.close()
        with torch.no_grad():
            out.append({k: v.numpy() for k, v in assemble_train_batch(
                ploop.upload_batch(loaded, "cpu")).items()})
    return out


def test_stats_are_the_global_batch_s(run, tmp_path):
    cfg = run["cfg"]
    parts = _first_batches(run)
    st = pstate.init_state(cfg, seed=0, device="cpu")
    sds = {n: {k: v.numpy().copy() for k, v in getattr(st, n).state_dict()
               .items()} for n in ("g", "d", "dp", "g_ema")}
    kw = dict(do_r1_d=True, do_r1_dp=True)      # step 0 runs R1
    got = ranks.run(WORLD, "step", dict(
        cfg=cfg, state=sds, kw=kw, batch={k: np.concatenate(
            [p[k] for p in parts]) for k in parts[0]}), tmp_path)
    row = _rows(run["first"])[0]
    for k, v in got[0]["metrics"].items():
        np.testing.assert_allclose(row[k]["mean"], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # rank 0's rows alone give other numbers
    import dataclasses
    local = dataclasses.replace(cfg, data_axis_size=1, batch_size=2)
    st = pstate.init_state(local, seed=0, device="cpu")
    _, m = make_train_step(local)(st, pstate.batch_to(parts[0], "cpu"),
                                  torch.Generator().manual_seed(0), **kw)
    m = fetch_metrics([m])[0]
    assert not np.isclose(m["g_l1"], row["g_l1"]["mean"], rtol=1e-3)


def test_every_rank_resumes_bit_equal(run, tmp_path):
    ckpt = os.path.join(run["first"], "ckpt-000002.pt")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    got = ranks.run(WORLD, "start", dict(cfg=run["cfg"], resume=ckpt),
                    tmp_path)
    for res in got:
        for name in ("g", "d", "dp", "g_ema"):
            for k, v in saved[name].items():
                assert np.array_equal(res[name][k], v.numpy()), (name, k)
        for name in ("g_opt", "d_opt", "dp_opt"):
            state = saved[name]["state"]
            assert len(res[name]) == sum(len(s) for s in state.values())
            for i, s in state.items():
                for k, v in s.items():
                    assert np.array_equal(res[name][(i, k)], v.numpy())
        assert (res["step"], res["ada_p"], res["pl_mean"]) == (
            saved["step"], saved["ada_p"], saved["pl_mean"])
    final = torch.load(os.path.join(run["again"], "ckpt-000003.pt"),
                       map_location="cpu", weights_only=True)
    assert final["step"] == 3 and final["cur_nimg"] == 12
