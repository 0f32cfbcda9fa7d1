"""End-to-end try-on serving on one GPU, or one batch split over several
(`mesh=`): device preprocessing + generator (port of pasta_tpu/serving.py).

The host does decode / keypoint parsing / label routing / homography solves
(numpy, data/host.py); everything else -- person conditioning rasters
(with cond="device"), patch warps, erosion, compositing, sleeve
mirroring, conflict zeroing, input assembly and the generator forward --
runs as torch ops on the device. The two-stage API of the JAX package
(ingest_device, then assemble_inputs_device) is kept; its TPU layout
reason does not apply. `TryonPipeline.run_stream` overlaps the host prep
of later batches with the device's work on the current one.

On a card, `run_batch` queues a batch's device work (ingest, assemble,
generator: some 3,300 kernels) as one replay of a CUDA graph captured for
its batch key (batch size, each uploaded array's shape and dtype, the
path); a server that sends many batch sizes holds one graph a size.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import threading
import weakref
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import tracing
from .data import device_cond as dc
from .data.device_warp import (MASK_THRESH, bound_from_mask_top, erode,
                               mirror_sleeves_device, normalize_patches_device,
                               normalize_patches_device_tiled,
                               resolve_warp_impl, zero_bound_above_mask_bottom,
                               zero_conflicts_device)
from .data.host import host_prepare
from .nn.synthesis import NoiseRows
from .shapes import assert_batch_shapes

_INGEST_F32_KEYS = ("upper_img", "lower_img", "upper_mask", "lower_mask",
                    "sleeve", "image", "pose", "retain_mask", "bound")


def compute_device_cond(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw parsing/image planes + scalar params -> every host-mode
    conditioning array (pose, retain_mask, skin_color, masked garment
    streams, label/bound planes)."""
    out = dict(host)
    parsing = out.pop("parsing")
    out["pose"] = dc.draw_pose_device(
        out.pop("limb_pts"), out.pop("limb_valid"),
        out.pop("joint_pts"), out.pop("joint_valid"), out.pop("pose_xlim"))
    palm = dc.palm_mask_device(out.pop("palm_quads"), out.pop("palm_valid"),
                               parsing)
    out["retain_mask"] = dc.retain_mask_device(parsing, palm)
    out["skin_color"] = dc.skin_median_device(host["image"], parsing)

    up = dc.garment_lut_mask(out.pop("upper_lut"), out.pop("upper_src_parsing"))
    low = dc.garment_lut_mask(out.pop("lower_lut"),
                              out.pop("lower_src_parsing"))
    out["upper_img"] = up * out.pop("upper_src_image").float()
    out["lower_img"] = low * out.pop("lower_src_image").float()
    out["upper_mask"] = up * 255.0
    out["lower_mask"] = low * 255.0
    gp = out.pop("sleeve_parsing")
    out["sleeve"] = ((gp == 10) | (gp == 11)).float()

    b, h = parsing.shape[0], parsing.shape[1]
    cls = out.pop("label_cls").float()
    out["label"] = (cls * 127.5)[:, None, None, None].expand(b, h, h, 1)
    row = out.pop("bound_row")
    yy = torch.arange(h, dtype=torch.int32, device=parsing.device)
    out["bound"] = (((yy[None, :] >= row[:, None]).float() * 255.0)
                    [:, :, None, None].expand(b, h, h, 1))
    return out


def ingest_device(host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stage 1: uint8 host arrays -> fp32 model-input planes, with the
    person conditioning computed on the device for cond="device" batches."""
    out = dict(host)
    if "parsing" in out:
        out = compute_device_cond(out)
    for k in _INGEST_F32_KEYS:
        out[k] = out[k].float()
    if "label" not in out:
        out["label"] = out["label_cls"].float() * 127.5
    out.pop("label_cls", None)
    return out


def assemble_inputs_device(host: Dict[str, torch.Tensor], mode: str,
                           tiled: bool = False):
    """Device: warps + assembly -> generator input dict.

    The cut and paste warps are the bilinear gather. tiled=True uses the
    fixed-tile paste path; callers must have verified host["tiles_fit"]
    for every item. Accepts the raw host_prepare batch or ingest_device's
    output.
    """
    host = ingest_device(host)
    res = host["image"].shape[1]
    # input contracts (reference misc.assert_shape style): a transposed or
    # mis-stacked host array fails here by name, not inside the warps
    assert_batch_shapes(host, {
        "image": (None, res, res, 3), "pose": (None, res, res, 3),
        "upper_img": (None, res, res, 3), "lower_img": (None, res, res, 3),
        "upper_mask": (None, res, res, 1), "lower_mask": (None, res, res, 1),
        "sleeve": (None, res, res, 1),
        "retain_mask": (None, res, res, 1), "bound": (None, res, res, 1),
        "upper_cut_m": (None, None, 3, 3), "lower_cut_m": (None, None, 3, 3),
        "paste_m_inv": (None, None, 3, 3), "skin_color": (None, 3),
    }, name="host")
    erode_k = 8 if mode == "upper" else 5
    common = dict(erode_k=erode_k, track_wo_sleeve=(mode == "upper"),
                  sleeve_valid=host.get("sleeve_valid"))
    args = (host["upper_img"], host["lower_img"], host["upper_mask"],
            host["lower_mask"], host["sleeve"], host["upper_cut_m"],
            host["lower_cut_m"], host["paste_m_inv"], host["part_valid"])
    if tiled:
        norm = normalize_patches_device_tiled(*args, host["tile_offsets"],
                                              **common)
    else:
        norm = normalize_patches_device(*args, **common)
    if mode in ("upper", "lower"):
        norm = zero_conflicts_device(norm)
    norm = mirror_sleeves_device(norm)

    denorm_upper = norm["denorm_upper_img"]
    denorm_lower = norm["denorm_lower_img"]
    bound = host["bound"]
    if mode == "upper":
        kept = (erode(host["lower_mask"], 8) >= MASK_THRESH).float()
        denorm_lower = host["lower_img"] * kept
        wo_sleeve_mask = (norm["denorm_upper_img_wo_sleeve"].sum(
            dim=-1, keepdim=True) > 0).float()
        bound = zero_bound_above_mask_bottom(bound, wo_sleeve_mask)
    if mode == "lower":
        kept = (erode(host["upper_mask"], 8) >= MASK_THRESH).float()
        denorm_upper = host["upper_img"] * kept
    if mode == "full":
        denorm_lower_mask = (denorm_lower.sum(dim=-1, keepdim=True)
                             > 0).float()
        bound = (bound_from_mask_top(denorm_lower_mask)
                 * host["dress_transfer"][:, None, None, None])

    def norm01(x):
        return x / 127.5 - 1.0

    image = norm01(host["image"])
    retain = image * host["retain_mask"] - (1 - host["retain_mask"])
    n = image.shape[0]
    skin = norm01(host["skin_color"])[:, None, None, :].expand(image.shape)
    return dict(
        z=torch.zeros((n, 0), device=image.device),
        c=torch.cat([norm01(norm["norm_img"]),
                     norm01(norm["norm_img_lower"])], dim=-1),
        retain=torch.cat([retain, skin], dim=-1),
        pose=torch.cat([norm01(host["pose"]), norm01(host["label"]),
                        norm01(bound)], dim=-1),
        denorm_upper_input=norm01(denorm_upper),
        denorm_lower_input=norm01(denorm_lower),
        denorm_upper_mask=(denorm_upper.sum(dim=-1, keepdim=True)
                           > 0).float(),
        denorm_lower_mask=(denorm_lower.sum(dim=-1, keepdim=True)
                           > 0).float(),
    )


class NoiseSeeds:
    """The synthesis noise of noise_mode="random", one draw a batch: a host
    generator seeded with `seed` gives each batch a seed, and a generator on
    `device` is reseeded with it, so that batch k gets the same noise
    however many draws batch k - 1 made (the JAX package splits its noise
    key once a batch)."""

    def __init__(self, seed, device):
        self._seeds = torch.Generator().manual_seed(seed)
        self._noise = torch.Generator(device=device)

    def next_seed(self):
        """The seed of the next batch."""
        return int(torch.randint(2 ** 62, (), generator=self._seeds))

    def next(self):
        """The generator for the next batch."""
        return self._noise.manual_seed(self.next_seed())


def _mesh_devices(mesh):
    """The mesh's entries as torch devices, "cuda" as the current card."""
    devices = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devices.append(d)
    if not devices:
        raise ValueError("TryonPipeline: an empty mesh")
    return devices


def _close_pools(pools):
    for pool in pools:
        pool.shutdown(wait=True)


def _stage(host_items, pin):
    """Each array of the items stacked into one host tensor, in pinned
    memory where `pin`."""
    batch = {}
    for k in host_items[0]:
        if k == "tiles_fit":
            continue
        arrs = [np.asarray(it[k]) for it in host_items]
        dtype = torch.from_numpy(np.empty(0, arrs[0].dtype)).dtype
        host = torch.empty((len(arrs),) + arrs[0].shape, dtype=dtype,
                           pin_memory=pin)
        np.stack(arrs, out=host.numpy())
        batch[k] = host
    return batch


class _Graph(NamedTuple):
    """One batch key's captured device work: the graph and the device
    tensors it reads (`upload` copies a batch into them) and writes."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    output: torch.Tensor


class TryonPipeline:
    """Batched serving: host_prepare -> ingest_device ->
    assemble_inputs_device -> Generator, on one device or split over a
    mesh.

    `model` is the port's Generator with its weights loaded, on the device
    that serves. `cond` is "device" (the person conditioning computed in
    ingest_device; the port's serving default) or "host" (host_prepare
    rasters it; the JAX pipeline's default). `noise_mode` is "const",
    "random" or "none"; "random" draws the synthesis noise on the model's
    device, one seed a batch from `seed` (NoiseSeeds). `warp_impl` names
    the cut and paste warps: "auto" or "gather", the port's one warp
    (`resolve_warp_impl`); it is taken for the JAX pipeline's signature.

    `mesh`, the counterpart of the JAX pipeline's one-axis Mesh, is an
    ordered sequence of torch devices ("cuda:0", torch.device("cuda", 1),
    ...; its size is its length). The model is copied once to each
    distinct device of the mesh (the device it lies on uses it as it is),
    and `run_batch` splits a batch, whose size the mesh's size must
    divide, into that many shards of contiguous rows: shard k runs on the
    mesh's k-th device. A device may appear more than once; it then serves
    its shards in turn (so the split runs on one card, or on the CPU).
    Each distinct device has one host thread of the pipeline's own that
    queues its shards; `close()` (or leaving a `with` block) ends them.
    Under noise_mode="random" every shard gets its rows of the noise that
    the pipeline without a mesh draws for the same batch and seed.

    On a card, without a mesh and with noise_mode other than "random",
    `run_batch` runs a batch's device work as one replay of a CUDA graph:
    the first batch of a key (batch size, each uploaded array's shape and
    dtype, the tiled path, `mode`) runs eagerly on a side stream, and its work is
    then captured; later batches of the key copy their arrays into the
    graph's inputs and replay it, and get a copy of its output (a caller
    may keep an image while later batches run). The graphs of a pipeline
    share one memory pool and one set of input tensors a key: a lock lets
    one thread at a time copy in, replay and copy out, and an event orders
    that device work after the previous batch's, whatever stream each
    calling thread queues on. `graph_counts` counts the batches
    that replayed, captured or ran eagerly (the mesh, "random" noise, the
    CPU); `graph_keys` the keys held.

    While a torch.profiler profile is active the pipeline records spans
    (`tracing.py`): `prepare_pair` (children `decode`, `host_prepare`),
    `run_batch` (attribute `graph`: "replay", "capture" or "eager";
    children `upload`, then `replay` on a replayed batch, else `ingest`,
    `assemble`, `generator`; under a mesh on the shards' threads), and in
    `run_stream` `prep_wait`, `fetch` and `fetch_wait`; every span of one
    batch, its prep on the pool's threads included, carries its batch id.
    """

    def __init__(self, model, mode="upper", noise_mode="const",
                 warp_impl="auto", cond="device", mesh=None, seed=0):
        if noise_mode not in ("const", "random", "none"):
            raise ValueError(f"noise_mode {noise_mode!r}")
        if cond not in ("device", "host"):
            raise ValueError(f"cond {cond!r}")
        self.model = model
        self.mode = mode
        self.warp_impl = resolve_warp_impl(warp_impl)
        self.noise_mode = noise_mode
        self.cond = cond
        self.device = next(model.parameters()).device
        self.mesh = None
        if mesh is not None:
            self.mesh = _mesh_devices(mesh)
            self.device = self.mesh[0]        # where run_batch's output lies
            home = next(model.parameters()).device
            self._replicas = {
                d: model if d == home else copy.deepcopy(model).to(d).eval()
                for d in dict.fromkeys(self.mesh)}
            self._pools = {
                d: concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix=f"TryonPipeline-{id(self)}-{d}")
                for d in self._replicas}
            self._shard_noise = [torch.Generator(device=d) for d in self.mesh]
            self._close = weakref.finalize(self, _close_pools,
                                           list(self._pools.values()))
        self._noise = NoiseSeeds(seed, self.device)
        self.last_tiled = None
        self._graphed = (self.device.type == "cuda" and self.mesh is None
                         and noise_mode != "random")
        self._graphs = {}
        self._side = self._pool = self._done = None
        self._graph_lock = threading.Lock()
        self.graph_counts = {"replay": 0, "capture": 0, "eager": 0}

    @property
    def graph_keys(self):
        """The batch keys whose device work is held as a CUDA graph."""
        return len(self._graphs)

    def close(self):
        """End the mesh's host threads (nothing without a mesh)."""
        if self.mesh is not None:
            self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def prepare(self, person, clothes, use_sleeve_mask=True):
        return host_prepare(person, clothes, self.mode, use_sleeve_mask,
                            cond=self.cond)

    def prepare_pair(self, root, pair, use_sleeve_mask=True,
                     with_images=False):
        """The host stage of one (person_name, clothes_name) pair of a
        data root, as run_stream runs it on its threads: decode, then
        host_prepare. The garment parsing (the sleeve mask's source) is
        read for the person in lower mode, for the clothes otherwise.
        With `with_images`, returns (item, the person's and the clothes'
        padded square images), which a caller composites from."""
        from .data import preprocess as pp

        pn, cn = pair
        sleeve_for = "person" if self.mode == "lower" else "clothes"
        with tracing.span("prepare_pair"):
            with tracing.span("decode"):
                person = pp.load_person(
                    root, pn,
                    pose_raster="device" if self.cond == "device" else "host",
                    with_garment_parsing=(use_sleeve_mask
                                          and sleeve_for == "person"))
                # host_prepare never reads the clothes pose image
                clothes = pp.load_person(
                    root, cn, pose_raster="device",
                    with_garment_parsing=(use_sleeve_mask
                                          and sleeve_for == "clothes"))
            with tracing.span("host_prepare"):
                item = self.prepare(person, clothes, use_sleeve_mask)
        return (item, person.image, clothes.image) if with_images else item

    def _upload(self, host_items, device=None):
        """Stack each array of the items and copy it to `device` (the
        pipeline's by default). On a card the stack is written into pinned
        host memory and copied without blocking the host (PyTorch's
        pinned-memory cache keeps the block until its copy is done)."""
        device = self.device if device is None else device
        pin = device.type == "cuda"
        return {k: t.to(device, non_blocking=pin)
                for k, t in _stage(host_items, pin).items()}

    def _forward(self, model, device, host_items, tiled, generator,
                 parent=None):
        """Queue one batch (or shard) on `device`. A shard's spans run on
        its device's thread: `parent` is its batch's `run_batch` span, and
        each carries the device."""
        at = {} if parent is None else {"parent": parent,
                                        "device": str(device)}
        with tracing.span("upload", **at):
            batch = self._upload(host_items, device)
        return self._device_work(model, batch, tiled, generator, at)

    def _device_work(self, model, batch, tiled, generator, at=None):
        """ingest -> assemble -> generator on an uploaded batch."""
        at = at or {}
        with tracing.span("ingest", **at):
            host = ingest_device(batch)
        with tracing.span("assemble", **at):
            inputs = assemble_inputs_device(host, self.mode, tiled=tiled)
        with tracing.span("generator", **at):
            _, finetune, _ = model(noise_mode=self.noise_mode,
                                   generator=generator, **inputs)
        return finetune

    def _queue_shards(self, device, stream, shards, tiled, parent):
        """One device's host thread: queue its shards' work, in order, on
        `stream`; returns [(shard index, finetune)] without waiting."""
        on = (torch.cuda.stream(stream) if device.type == "cuda"
              else contextlib.nullcontext())
        with torch.inference_mode(), on:
            return [(k, self._forward(self._replicas[device], device, items,
                                      tiled, noise, parent))
                    for k, items, noise in shards]

    def _run_shards(self, host_items, tiled, parent):
        """The batch split over the mesh: the finetune image of each shard
        on its device, queued and not waited for; `parent` is the batch's
        `run_batch` span."""
        size = len(self.mesh)
        assert len(host_items) % size == 0, (
            f"batch {len(host_items)} not divisible by mesh size {size}")
        b = len(host_items) // size
        seed = (self._noise.next_seed() if self.noise_mode == "random"
                else None)
        work = {d: [] for d in self._pools}
        for k, d in enumerate(self.mesh):
            noise = None
            if seed is not None:
                noise = NoiseRows(self._shard_noise[k].manual_seed(seed),
                                  k * b, len(host_items))
            work[d].append((k, host_items[k * b:(k + 1) * b], noise))
        futures = [
            self._pools[d].submit(
                self._queue_shards, d,
                torch.cuda.current_stream(d) if d.type == "cuda" else None,
                shards, tiled, parent)
            for d, shards in work.items()]
        outs = [None] * size
        for f in futures:
            for k, out in f.result():
                outs[k] = out
        return outs

    def _paths(self, host_items):
        """Whether a batch takes the tiled paste: every item's quads fit."""
        self.last_tiled = all(bool(it["tiles_fit"]) for it in host_items)
        return self.last_tiled

    def _queue(self, host_items):
        """The batch's outputs, one a shard of the mesh (one without a
        mesh), queued and not waited for, inside its `run_batch` span."""
        tiled = self._paths(host_items)
        with tracing.batch(), tracing.span(
                "run_batch", size=len(host_items), tiled=tiled) as span:
            how = "eager"
            if self.mesh is not None:
                outs = self._run_shards(host_items, tiled, span)
            elif self._graphed:
                with torch.cuda.device(self.device):
                    out, how = self._run_graphed(host_items, tiled)
                outs = [out]
            else:
                generator = (self._noise.next()
                             if self.noise_mode == "random" else None)
                outs = [self._forward(self.model, self.device, host_items,
                                      tiled, generator)]
            with self._graph_lock:
                self.graph_counts[how] += 1
            if span is not None:
                span.attrs["graph"] = how
            return outs

    def _run_graphed(self, host_items, tiled):
        """`_replay_or_capture` for one thread at a time, its device work
        queued after the previous graphed batch's."""
        with self._graph_lock:
            here = torch.cuda.current_stream(self.device)
            if self._done is None:
                self._done = torch.cuda.Event()
            here.wait_event(self._done)
            out, how = self._replay_or_capture(host_items, tiled)
            self._done.record(here)
        return out, how

    def _replay_or_capture(self, host_items, tiled):
        """(the batch's output, "replay" or "capture"): the replay of its
        key's graph, into a tensor of the caller's own; or, for a key not
        seen before, the batch run eagerly and its work captured."""
        with tracing.span("upload"):
            staged = _stage(host_items, pin=True)
            key = (tiled, self.mode,
                   tuple((k, tuple(t.shape), t.dtype)
                         for k, t in staged.items()))
            graph = self._graphs.get(key)
            if graph is None:
                batch = {k: t.to(self.device, non_blocking=True)
                         for k, t in staged.items()}
            else:
                for k, t in staged.items():
                    graph.inputs[k].copy_(t, non_blocking=True)
        if graph is None:
            return self._capture(key, batch, tiled), "capture"
        with tracing.span("replay"):
            graph.graph.replay()
            out = graph.output.clone()
        return out, "replay"

    def _capture(self, key, batch, tiled):
        """Run the batch eagerly on a side stream (the warm-up PyTorch asks
        for before a capture), then capture the same work on it into the
        pipeline's memory pool as `key`'s graph, reading `batch`'s tensors
        from then on. Returns the eager output."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side, here = self._side, torch.cuda.current_stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = self._device_work(self.model, batch, tiled, None)
        here.wait_stream(side)
        out.record_stream(here)     # the caller frees it after its reads
        graph = torch.cuda.CUDAGraph()
        # "thread_local": CUDA calls of a server's other threads do not
        # void the capture
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode="thread_local"):
            static = self._device_work(self.model, batch, tiled, None)
        self._graphs[key] = _Graph(graph, batch, static)
        return out

    @torch.inference_mode()
    def run_batch(self, host_items):
        """host_prepare dicts -> finetune images [B, H, W, 3] on the device
        (queued, not waited for). Takes the tiled paste path when every
        item's quads fit (`tiles_fit`). With a mesh, that choice is made
        over the whole batch before it is split, and the shards' outputs
        are gathered on the mesh's first device.
        """
        outs = self._queue(host_items)
        if self.mesh is None:
            return outs[0]
        # device-to-device copies, ordered after each source's stream
        return torch.cat([o.to(self.device, non_blocking=True)
                          for o in outs])

    def run_stream(self, root, pairs, batch_size=8, use_sleeve_mask=True,
                   num_workers=8, prefetch=2, with_images=False):
        """Overlapped serving over (person_name, clothes_name) pairs of a
        data root (directory, .zip or DataRoot).

        Host prep (decode + host_prepare) of the next `prefetch` batches
        runs on `num_workers` threads while the device runs the current
        batch. Each batch's upload and launches are queued without a wait
        (pinned staging, see `_upload`), its output is copied into pinned
        host memory behind them, and the host waits for that copy only
        after it has queued the next batch: the output comes one batch
        late. Yields (pairs_chunk, outputs [len(chunk), H, W, 3] float32
        numpy) in order. The tail batch is padded to `batch_size` with
        copies of its last item. With `with_images`, each yield also
        carries the chunk's [(person image, clothes image)] that the prep
        threads decoded (`prepare_pair`), so that a caller writing
        composites decodes nothing again. With a mesh, `batch_size` is a
        multiple of its size, and each shard's output is copied from its
        device straight into its rows of the host buffer.
        """
        import collections

        from .data.roots import as_root

        root = as_root(root)

        def prep(pair, bid):
            with tracing.batch(bid):
                return self.prepare_pair(root, pair, use_sleeve_mask,
                                         with_images)

        def submit(chunk):
            bid = tracing.new_batch()     # the id its spans share
            return chunk, bid, [pool.submit(prep, p, bid) for p in chunk]

        def fetch(outs):
            """Queue the copy of a batch's output, shard by shard, into its
            rows of one pinned host buffer; returns the host tensor and one
            event a card that marks the end of its copies."""
            outs = [o.float() for o in outs]
            pin = self.device.type == "cuda"
            rows = sum(len(o) for o in outs)
            host = torch.empty((rows,) + outs[0].shape[1:],
                               dtype=torch.float32, pin_memory=pin)
            row = 0
            for o in outs:
                host[row:row + len(o)].copy_(o, non_blocking=pin)
                row += len(o)
            done = []
            for d in dict.fromkeys(o.device for o in outs) if pin else ():
                done.append(torch.cuda.Event())
                done[-1].record(torch.cuda.current_stream(d))
            return host, done

        def run(items):
            return ([self.run_batch(items)] if self.mesh is None
                    else self._queue(items))

        prefetch = max(1, prefetch)
        pairs = list(pairs)
        chunks = [pairs[i:i + batch_size]
                  for i in range(0, len(pairs), batch_size)]
        with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
            inflight = collections.deque(submit(c)
                                         for c in chunks[:prefetch])
            next_chunk = prefetch
            pending = None
            while inflight:
                chunk, bid, futs = inflight.popleft()
                with tracing.span("prep_wait", batch=bid):
                    items = [f.result() for f in futs]
                images = None
                if with_images:
                    images = [(p, c) for _, p, c in items]
                    items = [it for it, _, _ in items]
                while len(items) < batch_size:
                    items.append(items[-1])
                with tracing.batch(bid):
                    outs = run(items)                   # queued, no wait
                with tracing.span("fetch", batch=bid):
                    out = fetch(outs)
                if next_chunk < len(chunks):
                    inflight.append(submit(chunks[next_chunk]))
                    next_chunk += 1
                if pending is not None:
                    yield self._finish(*pending)
                pending = (chunk, bid, images, *out)
            if pending is not None:
                yield self._finish(*pending)

    @staticmethod
    def _finish(chunk, bid, images, host, done):
        with tracing.span("fetch_wait", batch=bid):
            for event in done:
                event.synchronize()
        out = host.numpy()[:len(chunk)]
        return (chunk, out) if images is None else (chunk, out, images)
