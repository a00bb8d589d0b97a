"""Generation pipeline: the batch step and the streaming runtime (port of
``flowgen/pipeline/generator.py``).

A batch is a pure function of ``(seed, step)``: sample the scenes of global
indices ``step*B .. step*B+B-1``, render them and adapt the output. Frames of
multiples of (8, 128) render through the scene kernel (``compose/fused.py``);
other frame sizes, and the settings that ask for it, through the windowed
renderer (``compose/render.py``), as :func:`use_fused_path` decides.
PyTorch enqueues device work asynchronously, so the runtime keeps
``prefetch`` steps in flight on the current CUDA stream.

The texture bank is a (T, 2H, 2W, 3) atlas or a ``texture_io.TextureDB``,
whose sources keep their native sizes on the scene kernel's path. With
``photometric_augment`` the frames get FlowNet's photometric jitter
(``ops/photometric.py``) after either renderer.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .. import texture_io
from ..compose.fused import masks_from_ids, render_batch_fused
from ..compose.render import _pallas_enabled, prepare_atlas, render_batch
from ..config import DataGenConfig
from ..ops import photometric
from ..ops.scene import (
    fused_eligible,
    prepare_bg_slabs,
    prepare_bg_slabs_db,
    prepare_obj_slabs,
    prepare_slabs,
    quadrant_needed,
    slab_shape,
)
from ..params.sampler import sample_scene_batch
from ..random.streams import root_key
from ..texture_io import TextureDB
from ..utils.profiling import ThroughputMeter, span
from ..warpfields import generator as warpgen


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device. Raises when CUDA
    is requested and no card is present: the port never falls back to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flowgen_torch runs on a CUDA device; none is available. Pass "
            "device='cpu' to run the plain PyTorch path on the CPU."
        )
    return dev


def _adapt_output(images0, images1, flow0, flow1, cfg: DataGenConfig,
                  masks=None):
    """Output-compatibility transforms: BGR channel order, NCHW layout and
    the disparity output of the horizontal-only modes."""
    with span("flowgen.adapt"):
        if cfg.warp_oob == "nan" and cfg.mode_spec.warp_p > 0.0:
            # Decode the bank's OOB sentinel back into NaN forward flow.
            flow0 = torch.where(torch.abs(flow0) > warpgen.OOB_FLOW_THRESH,
                                torch.full_like(flow0, float("nan")), flow0)
        if cfg.channel_order == "bgr":
            images0 = images0.flip(-1)
            images1 = images1.flip(-1)
        out = {"image0": images0, "image1": images1, "flow0": flow0}
        if flow1 is not None:
            out["flow1"] = flow1
        if cfg.layout == "nchw":
            out = {k: v.movedim(-1, 1) for k, v in out.items()}
        if masks is not None:
            out["occlusion"], out["motion_boundary"] = masks
        if cfg.mode_spec.horizontal_only:
            out["disparity"] = -(
                flow0[..., 0] if cfg.layout == "nhwc" else out["flow0"][:, 0]
            )
        return out


def _as_u8(atlas) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(atlas)) if not torch.is_tensor(atlas) else atlas
    if a.dtype != torch.uint8:
        a = torch.clamp(torch.round(a.to(torch.float32)), 0, 255).to(torch.uint8)
    return a


def use_fused_path(cfg: DataGenConfig, device) -> bool:
    """Whether this configuration renders through the scene kernel
    (``compose/fused.py``) on ``device``. ``cfg.render_impl`` is the dial:
    "fused" (the default) takes the kernel whenever the frame is a multiple
    of (8, 128) and the mode's envelope fits a texture sub-tiling;
    "windowed", ``use_pallas="never"`` and ``windowed=False`` take the
    windowed renderer; "auto" takes the kernel only where the window kernels
    would run too (a CUDA device, or ``use_pallas="always"``)."""
    if cfg.render_impl == "windowed" or cfg.use_pallas == "never":
        return False
    eligible = cfg.windowed and fused_eligible(cfg.mode_spec, cfg.height,
                                               cfg.width)
    if cfg.render_impl == "auto":
        return eligible and _pallas_enabled(cfg, device)
    return eligible


def make_atlas_packer(device):
    """Cache of the quad-packed atlas (``compose/render.py:prepare_atlas``)
    that the windowed renderer samples, packed once per distinct atlas
    object; an atlas already packed (last dim 12) passes through. A
    TextureDB gives its ``canonical`` array."""
    cache = {}

    def packed(atlas):
        if isinstance(atlas, TextureDB):
            atlas = atlas.canonical
        if torch.is_tensor(atlas) and atlas.shape[-1] == 12:
            return atlas.to(device)
        if cache.get("id") != id(atlas):
            cache["id"] = id(atlas)
            cache["val"] = prepare_atlas(_as_u8(atlas).to(device))
        return cache["val"]

    return packed


def db_slab_bytes(db: TextureDB) -> int:
    """Device bytes that packing a TextureDB's background slabs holds at its
    peak: every slab is padded to the largest source (int32 texels), and the
    zero-padded sources are on the card as uint8 and as packed int32 while
    the slabs are built."""
    T, max_h, max_w = (int(n) for n in db.sources.shape[:3])
    hs, ws = slab_shape(max_h, max_w)
    return T * hs * ws * 4 + T * max_h * max_w * (3 + 4)


def _check_db_fits(db: TextureDB, device):
    """Raise before packing a TextureDB whose background slabs cannot fit in
    the card's free memory (one large source pads every slab to its size)."""
    if device.type != "cuda":
        return
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    need = db_slab_bytes(db)
    if need > free:
        T, max_h, max_w = (int(n) for n in db.sources.shape[:3])
        raise MemoryError(
            f"TextureDB background slabs need {need / 2**30:.2f} GiB on "
            f"{device}, {free / 2**30:.2f} GiB free: each of the {T} slabs is "
            f"padded to the largest source, {max_h}x{max_w}; shrink the "
            f"largest sources or split the database")


def make_slab_packer(cfg: DataGenConfig, device):
    """Cache of the scene kernel's packed texture slabs, built once per
    distinct atlas object: ``(obj_slabs, bg_slabs, src_hw, tex_sizes)``, the
    arguments of ``compose/fused.py:scene_tables`` after ``cfg``. For an
    atlas: its frame-sized centre crops (with their rot90 copies in the
    quadrant modes 11 and 13), its full sources, their (height, width) and
    no per-source sizes. For a TextureDB: its ``obj_tex``, its native
    sources with per-source reflect periods, the padded sources' (height,
    width) and their native sizes, a (T, 2) int32 tensor (h, w). A
    TextureDB whose slabs cannot fit in the card's free memory raises
    ``MemoryError`` before anything is allocated."""
    quadrant = quadrant_needed(cfg.mode_spec)
    cache = {}

    def slabs(atlas):
        if cache.get("id") == id(atlas):
            return cache["val"]
        if isinstance(atlas, TextureDB):
            _check_db_fits(atlas, device)
            sizes = torch.as_tensor(np.asarray(atlas.sizes, np.int32),
                                    device=device)
            val = (
                prepare_obj_slabs(_as_u8(atlas.obj_tex).to(device),
                                  quadrant=quadrant),
                prepare_bg_slabs_db(_as_u8(atlas.sources).to(device), sizes),
                tuple(int(n) for n in atlas.sources.shape[1:3]),
                sizes,
            )
        else:
            a = _as_u8(atlas).to(device)
            val = (
                prepare_slabs(a, cfg.height, cfg.width, quadrant=quadrant),
                prepare_bg_slabs(a),
                (a.shape[1], a.shape[2]),
                None,
            )
        cache["id"], cache["val"] = id(atlas), val
        return val

    return slabs


def generate_batch(root, step, atlas, cfg: DataGenConfig, base_index=None,
                   slabs=None, device=None, warp_aux=None, warp_bank=None):
    """One batch: samples ``cfg.batch_size`` scenes at global indices
    ``base_index .. base_index+B-1`` (default ``step*B``) and renders them.
    ``atlas`` is a (T, 2H, 2W, 3) texture bank or a ``TextureDB`` (the
    windowed renderer also takes it quad-packed, (T, 2H, 2W, 12)); ``slabs``
    optionally the scene kernel's pre-packed slabs
    (:func:`make_slab_packer`). ``root``
    is a key from ``random.streams.root_key`` or an int seed. In mode 9 the
    step's bank epoch may be passed (``make_generate_fn`` caches it per
    epoch): the scene kernel's warp planes (``warp_aux``, the ``WarpAux`` of
    ``warpfields/generator.py:make_bank_and_aux``) or the windowed
    renderer's crop bank (``warp_bank``, ``make_warp_bank``); otherwise it
    is built here from ``(root, step)``."""
    dev = resolve_device(device)
    if not torch.is_tensor(root):
        root = root_key(root, dev)
    root = root.to(dev)
    b = cfg.batch_size
    if base_index is None:
        base_index = int(step) * b
    indices = base_index + torch.arange(b, device=dev)
    warp = cfg.mode_spec.warp_p > 0.0
    n_slots = warpgen.bank_size(cfg) if warp else 1
    if not use_fused_path(cfg, dev):
        if warp and warp_bank is None:
            warp_bank = warpgen.make_warp_bank(root, step, cfg)
        scenes = sample_scene_batch(root, indices, cfg, n_warp_slots=n_slots)
        rendered = list(render_batch(scenes, make_atlas_packer(dev)(atlas),
                                     cfg, warp_bank if warp else None))
        if cfg.emit_masks:
            ids = rendered.pop()
            f0 = rendered[2]
            rendered += list(masks_from_ids(ids, f0[..., 0], f0[..., 1]))
        return _split_and_adapt(rendered, cfg, root, indices)
    if slabs is None:
        slabs = make_slab_packer(cfg, dev)(atlas)
    obj_slabs, bg_slabs, src_hw, tex_sizes = slabs
    if warp and warp_aux is None:
        _, warp_aux = warpgen.make_bank_and_aux(root, step, cfg)
    scenes = sample_scene_batch(root, indices, cfg, n_warp_slots=n_slots)
    return _split_and_adapt(
        render_batch_fused(scenes, obj_slabs, bg_slabs, src_hw, cfg,
                           warp_aux=warp_aux, tex_sizes=tex_sizes),
        cfg, root, indices)


def _split_and_adapt(rendered, cfg: DataGenConfig, root, indices):
    """A renderer's (image0, image1, flow0[, flow1][, occlusion,
    motion_boundary]), photometrically jittered when the configuration
    asks for it, through :func:`_adapt_output`."""
    rendered = list(rendered)
    i0, i1, f0 = rendered[:3]
    if cfg.photometric_augment:
        i0, i1 = photometric.augment_batch(root, indices, i0, i1)
    rest = rendered[3:]
    f1 = rest.pop(0) if cfg.compute_inverse_flow else None
    masks = tuple(rest) if cfg.emit_masks else None
    return _adapt_output(i0, i1, f0, f1, cfg, masks)


def _same_root(a, b) -> bool:
    if a is b:
        return True
    if torch.is_tensor(a) and torch.is_tensor(b):
        return a.device == b.device and torch.equal(a, b)
    return not torch.is_tensor(a) and not torch.is_tensor(b) and a == b


_BANK_LOCK = threading.Lock()
_BANK_STATS = {"demand": 0, "ahead": 0}


def bank_epoch_stats() -> dict:
    """How many bank epochs every :class:`BankEpochCache` has built since
    the process started: on demand (a step found its epoch missing) and
    ahead (:meth:`BankEpochCache.prefetch_next`). The ``flowgen.bank_epoch``
    span carries the same word as its argument."""
    with _BANK_LOCK:
        return dict(_BANK_STATS)


def _count_build(how: str):
    with _BANK_LOCK:
        _BANK_STATS[how] += 1


class BankEpochCache:
    """What ``build_fn(root, step)`` makes for a bank epoch (``step //
    reuse``) of one root and content stream (``warp_bank_impl``), built
    once per (root, stream, epoch); a call with another root drops what was
    cached, and two streams never share an epoch's entry.
    :meth:`prefetch_next`, called after a step's work is enqueued, builds
    the next epoch on an epoch's last step. An eager build launches its many small ops from the host,
    so this moves the epoch's host time to the tail of the step before the
    boundary and costs all of it there; it hides only the device time that
    overlaps with the step's. A seek elsewhere only wastes the prediction;
    results stay exact. Each build counts in :func:`bank_epoch_stats`.

    A build may reuse the memory of the epoch it returned an even number of
    epochs before (``warpfields/generator.py:BankAuxGraphs``), so the cache
    forgets an epoch of the parity it is about to build: it holds at most
    one of each."""

    def __init__(self, build_fn, reuse: int, stream: str = "pallas"):
        self._build = build_fn
        self._reuse = max(reuse, 1)
        self._stream = stream
        self._c = {}

    def _for_root(self, root):
        if not _same_root(self._c.get("root"), root):
            self._c = {"root": root}
        return self._c

    def _epoch(self, step: int):
        return self._stream, int(step) // self._reuse

    @staticmethod
    def _forget_parity(c, epoch):
        for at, val in (("epoch", "val"), ("next_epoch", "next_val")):
            e = c.get(at)
            if e is not None and e != epoch and (e[1] - epoch[1]) % 2 == 0:
                del c[at], c[val]

    def get(self, root, step: int):
        c = self._for_root(root)
        epoch = self._epoch(step)
        if c.get("epoch") != epoch:
            if c.get("next_epoch") == epoch:
                c["val"] = c.pop("next_val")
                del c["next_epoch"]
            else:
                self._forget_parity(c, epoch)
                with span("flowgen.bank_epoch", "demand"):
                    c["val"] = self._build(root, epoch[1] * self._reuse)
                _count_build("demand")
            c["epoch"] = epoch
        return c["val"]

    def prefetch_next(self, root, step: int):
        c, reuse = self._for_root(root), self._reuse
        nxt = (self._stream, int(step) // reuse + 1)
        if int(step) % reuse == reuse - 1 and c.get("next_epoch") != nxt:
            self._forget_parity(c, nxt)
            with span("flowgen.bank_epoch", "ahead"):
                c["next_val"] = self._build(root, nxt[1] * reuse)
            _count_build("ahead")
            c["next_epoch"] = nxt


def _generate_fn(cfg: DataGenConfig, dev, part: int = 0, parts: int = 1):
    """``fn(root, step, atlas)`` rendering rows ``[part*B/parts,
    (part+1)*B/parts)`` of step ``step``'s global batch of ``cfg.batch_size``
    on ``dev``: the scene kernel's slabs, or the windowed renderer's
    quad-packed atlas, packed once per atlas; in mode 9 the bank epoch is
    built from the global ``cfg`` (it does not depend on the batch size) and
    cached (:class:`BankEpochCache`)."""
    local = cfg if parts == 1 else dataclasses.replace(
        cfg, batch_size=cfg.batch_size // parts)
    fused = use_fused_path(local, dev)
    pack = make_slab_packer(local, dev) if fused else make_atlas_packer(dev)

    def batch(root, step, atlas, **extra):
        base = int(step) * cfg.batch_size + part * local.batch_size
        if fused:
            return generate_batch(root, step, atlas, local, base_index=base,
                                  slabs=pack(atlas), device=dev, **extra)
        return generate_batch(root, step, pack(atlas), local, base_index=base,
                              device=dev, **extra)

    if cfg.mode_spec.warp_p == 0.0:
        return batch

    graphs = (warpgen.BankAuxGraphs(cfg, dev) if fused and dev.type == "cuda"
              and cfg.warp_bank_impl == "pallas" else None)

    def build(root, step):
        key = root.to(dev) if torch.is_tensor(root) else root_key(root, dev)
        if graphs is not None:
            return graphs(key, step)
        if fused:
            return warpgen.make_bank_and_aux(key, step, cfg)[1]
        return warpgen.make_warp_bank(key, step, cfg)

    epochs = BankEpochCache(build, cfg.warp_bank_reuse_steps,
                            cfg.warp_bank_impl)

    def fn(root, step, atlas):
        val = epochs.get(root, int(step))
        out = batch(root, step, atlas,
                    **{"warp_aux" if fused else "warp_bank": val})
        epochs.prefetch_next(root, int(step))
        return out

    return fn


def make_generate_fn(cfg: DataGenConfig, device=None, mesh=None):
    """``fn(root, step, atlas) -> batch`` with the scene kernel's slabs, or
    the windowed renderer's quad-packed atlas, packed once per atlas. In
    mode 9 what the renderer takes of a bank epoch (the scene kernel's warp
    planes, or the windowed renderer's crop bank) is cached per (root, bank
    epoch) (``cfg.warp_bank_reuse_steps`` steps) and the next epoch's is
    built ahead (:class:`BankEpochCache`). With a ``DeviceMesh``, the batch
    is split over its ``data`` dimension on the rank's own device
    (``pipeline/sharding.py:make_sharded_generate_fn``) and its values are
    DTensors."""
    if mesh is not None:
        from .sharding import make_sharded_generate_fn

        return make_sharded_generate_fn(cfg, mesh)
    return _generate_fn(cfg, resolve_device(device))


def make_mixed_generate_fn(cfgs, weights=None, device=None, mesh=None):
    """A deterministic per-step mixture of configurations (the IJCV paper's
    dataset-mixing experiments): ``fn(root, step, atlas)`` renders step
    ``step`` with the ingredient that a host-side counter-based draw keyed
    by ``(seed, step)`` picks, so the mixed stream stays seekable.
    ``cfgs``: one ``DataGenConfig`` per ingredient, sharing batch and frame
    sizes and the output signature; ``weights``: the mixture's
    probabilities (default uniform). Each ingredient keeps its own
    :func:`make_generate_fn` (on ``mesh`` when one is given: every rank
    draws the same pick), and with it its own bank cache."""
    if not cfgs:
        raise ValueError("need at least one config")
    sig = {
        (c.batch_size, c.height, c.width, c.layout, c.channel_order,
         c.compute_inverse_flow, c.emit_masks,
         c.mode_spec.horizontal_only)
        for c in cfgs
    }
    if len(sig) > 1:
        raise ValueError(
            "mixed-mode ingredients must share batch/frame dims and output "
            f"signature; got {sorted(sig)}"
        )
    p = np.full(len(cfgs), 1.0 / len(cfgs)) if weights is None else (
        np.asarray(weights, np.float64) / np.sum(weights)
    )
    cum = np.cumsum(p)
    fns = [make_generate_fn(c, device, mesh) for c in cfgs]
    seed = cfgs[0].seed

    def pick(step) -> int:
        u = np.random.default_rng([seed, int(step), 0x6D69785D]).random()
        return int(np.searchsorted(cum, u, side="right").clip(0, len(fns) - 1))

    def fn(root, step, atlas):
        return fns[pick(step)](root, step, atlas)

    return fn


class Generator:
    """Streaming batch source: start/stop/pause/resume, blocking
    ``retrieve_batch``, the iterator protocol, and a seekable ``step``
    counter for exact resume. ``prefetch`` steps stay enqueued on the
    current CUDA stream ahead of the consumer; ``meter`` counts the samples
    retrieved (``utils/profiling.py:ThroughputMeter``). With a
    ``DeviceMesh`` every rank runs its own Generator on its own device and
    retrieves its DTensor shard of each global batch
    (``pipeline/sharding.py``); ``as_numpy`` then gathers the global batch
    (``full_tensor()``, a collective on every rank)."""

    def __init__(
        self,
        cfg: DataGenConfig,
        atlas: Optional[np.ndarray] = None,
        start_step: int = 0,
        as_numpy: bool = False,
        device=None,
        mesh=None,
    ):
        self.cfg = cfg
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from .sharding import local_tensor, mesh_device

            self.device = mesh_device(mesh)
            atlas = local_tensor(atlas)
        if atlas is None:
            atlas = texture_io.atlas_for_config(cfg)
        if not use_fused_path(cfg, self.device):
            # The windowed renderer samples the quad-packed atlas: pack once.
            atlas = make_atlas_packer(self.device)(atlas)
        self._atlas = atlas
        self._root = root_key(cfg.seed, self.device)
        self._fn = make_generate_fn(cfg, self.device, mesh)
        self._step = start_step
        self._as_numpy = as_numpy
        self.meter = ThroughputMeter()
        self._running = False
        self._paused = threading.Event()
        self._paused.set()
        self._inflight = []
        self._lock = threading.Lock()

    def start(self):
        if self._running:
            return self
        self._running = True
        self._pump()
        return self

    def stop(self):
        self._running = False
        with self._lock:
            self._inflight.clear()
        return self

    def pause(self):
        self._paused.clear()
        return self

    def resume(self):
        self._paused.set()
        if self._running:
            self._pump()
        return self

    @property
    def step(self) -> int:
        """Next global step index; persist this for exact stream resume."""
        return self._step

    def seek(self, step: int):
        """Restart the stream at global ``step`` (drops in-flight steps)."""
        with self._lock:
            self._inflight.clear()
            self._step = int(step)
        if self._running:
            self._pump()
        return self

    def _dispatch(self):
        with span("flowgen.step", str(self._step)):
            out = self._fn(self._root, self._step, self._atlas)
        self._step += 1
        return out

    def _pump(self):
        with self._lock:
            while self._running and self._paused.is_set() and (
                len(self._inflight) < max(1, self.cfg.prefetch)
            ):
                self._inflight.append(self._dispatch())

    def retrieve_batch(self):
        """Blocking fetch of the next finished batch."""
        if not self._running:
            self.start()
        while not self._paused.is_set():
            time.sleep(0.001)
        with self._lock:
            out = self._inflight.pop(0) if self._inflight else self._dispatch()
        self._pump()
        if self._as_numpy:
            out = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                   .cpu().numpy() for k, v in out.items()}
        self.meter.tick(self.cfg.batch_size)
        return out

    def has_retrievable_batches(self) -> bool:
        return len(self._inflight) > 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self.retrieve_batch()
