"""The API-0 encode and the decode's apply over a mesh of devices.

Port of ``libultrahdr_tpu/parallel/batch.py``.  The single-image steps
(``encode_core_p010``, ``encode_core_p010_twopass``) and the batch step
(``encode_batch_p010``, a loop over the images where JAX has ``vmap``) are
the API-0 pixel pipeline of the reference (jpegr.cpp:173-231: toneMap ->
generateGainMap) without the JPEG stage.

The multi-device steps run over a ``Mesh``: a ("data", "spatial") grid of
torch devices driven by this one process, as JAX's ``shard_map`` drives
``jax.devices()`` from one.  Images shard over "data", the pixel rows of
each image over "spatial".  Each mesh position (a shard) queues its work
on its own device, on a side stream of that device (``fused.side_streams``,
in turn over the positions that share it), without waiting for the card;
the caller's stream then waits for the side streams.  A mesh may repeat a
device: ``[cuda:0] * 4`` drives the whole sharded path on one card, as the
8-virtual-device CPU mesh does for JAX.  The two collectives of the JAX
steps become copies between devices, each ordered after the source's work
by an event:

- ``lax.pmin`` / ``pmax`` of the two-pass bounds: each shard's (2, C)
  floats go to the first device of its spatial row, are reduced there and
  go back (both exact);
- the ``ppermute`` of one gain-map row in the apply: each shard but the
  last takes the next shard's first map row as its IDW halo.

Each step returns its outputs as ``Sharded`` values: every shard's tensor
stays on its device, in mesh order; ``Sharded.gather`` concatenates them
onto one device, as reading a JAX global array does.

Row sharding needs an even per-shard row count divisible by the gain-map
scale (4:2:0 chroma pairs and box windows never straddle shards), as the
reference's row jobs do (jpegr.cpp:1994); the JPEG step needs whole MCU rows
of both images per shard.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import fused
from ..errors import unsupported
from ..jpeg import device_entropy, native, pack_kernel
from ..jpegr import resolve_device
from ..ops import apply as apply_ops
from ..ops import gainmap as gainmap_ops, pixel
from ..ops import tonemap as tonemap_ops
from ..types import ColorGamut, ColorRange, ColorTransfer, ImgFmt


# ---------------------------------------------------------------------------
# single-image compute steps

def _as_device(x, device) -> torch.Tensor:
    """A tensor stays where it is; a host array goes to `device` (the card
    unless the caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return pixel.plane_tensor(x, resolve_device(device))


def encode_core_p010(y, uv, *, cg=ColorGamut.BT2100, ct=ColorTransfer.HLG,
                     rng=ColorRange.FULL, scale: int = 4,
                     multichannel: bool = False, gamma: float = 1.0,
                     device="cuda"):
    """The API-0 REALTIME encode's pixel step of one image: P010 planes y
    (H, W) and uv (H/2, W) (tensors, or host arrays sent to `device`) ->
    (SDR Y, U, V u8 planes, one-pass gain map u8 (C, H/scale, W/scale))."""
    return fused.api0_p010_pixels(
        _as_device(y, device), _as_device(uv, device), cg=cg, ct=ct, rng=rng,
        scale=scale, multichannel=multichannel, gamma=gamma,
        use_base_cg=True)


def _twopass_front(y, uv, *, cg, ct, rng, scale, multichannel):
    """BEST_QUALITY pass 1 (jpegr.cpp:830-960): (SDR Y, U, V, float log2
    gains (C, mh, mw), their per-channel min and max (C,))."""
    h, w = y.shape
    hdr_vals = pixel.unpack_p010(y, uv, rng, h, w)
    y8, u8, v8 = tonemap_ops.tonemap_to_yuv(hdr_vals, ImgFmt.P010, cg, ct)
    sdr_vals = pixel.unpack_yuv8(y8, u8, v8, 2, 2, h, w)
    gains, gmin, gmax = gainmap_ops.gainmap_float_pass(
        sdr_vals, hdr_vals, sdr_fmt=ImgFmt.YUV420, hdr_fmt=ImgFmt.P010,
        sdr_cg=ColorGamut.DISPLAY_P3, hdr_cg=cg, ct=ct, scale=scale,
        multichannel=multichannel, use_luminance=False, sdr_is_601=False,
        use_base_cg=True)
    return y8, u8, v8, gains, gmin, gmax


def _twopass_map(gains, gmin, gmax, gamma: float):
    """BEST_QUALITY pass 2 on the device (jpegr.cpp:947-1027): the bounds
    clipped and separated, the gains quantised.  Returns (map u8, lo,
    hi)."""
    c = gains.shape[0]
    lo = torch.clamp(gmin, gainmap_ops.GAIN_LOG2_MIN,
                     gainmap_ops.GAIN_LOG2_MAX)
    hi = torch.clamp(gmax, gainmap_ops.GAIN_LOG2_MIN,
                     gainmap_ops.GAIN_LOG2_MAX)
    hi = torch.where((hi - lo).abs() < float(np.finfo(np.float32).eps),
                     hi + 0.1, hi)
    gm = gainmap_ops.affine_map_gain(gains, lo[:c].reshape(c, 1, 1),
                                     hi[:c].reshape(c, 1, 1), gamma)
    return gm, lo, hi


def encode_core_p010_twopass(y, uv, *, cg=ColorGamut.BT2100,
                             ct=ColorTransfer.HLG, rng=ColorRange.FULL,
                             scale: int = 4, multichannel: bool = True,
                             gamma: float = 1.0, device="cuda"):
    """The API-0 BEST_QUALITY encode's pixel step of one image: (SDR Y, U,
    V, two-pass gain map u8, log2 bounds lo, hi (C,))."""
    y8, u8, v8, gains, gmin, gmax = _twopass_front(
        _as_device(y, device), _as_device(uv, device), cg=cg, ct=ct,
        rng=rng, scale=scale, multichannel=multichannel)
    return (y8, u8, v8) + _twopass_map(gains, gmin, gmax, gamma)


def encode_batch_p010(y, uv, *, cg=ColorGamut.BT2100, ct=ColorTransfer.HLG,
                      rng=ColorRange.FULL, scale: int = 4,
                      multichannel: bool = False, gamma: float = 1.0,
                      device="cuda"):
    """``encode_core_p010`` over a (B, H, W) / (B, H/2, W) P010 batch on one
    device: each output stacked over the batch."""
    y, uv = _as_device(y, device), _as_device(uv, device)
    outs = [encode_core_p010(y[i], uv[i], cg=cg, ct=ct, rng=rng, scale=scale,
                             multichannel=multichannel, gamma=gamma)
            for i in range(y.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# the mesh

def _normal_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ("data", "spatial") grid of torch devices: ``devices[d][s]`` runs
    data index d's images, spatial index s's rows.  "data" is the batch's
    data parallelism (throughput), "spatial" the rows of one image (the
    latency of a huge image).  A device may appear more than once; the
    devices are all CUDA devices or all the CPU."""

    axis_names = ("data", "spatial")

    def __init__(self, devices):
        self.devices = [[_normal_device(d) for d in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        kinds = {d.type for row in self.devices for d in row}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices are all cuda or all cpu, got "
                             f"{sorted(kinds)}")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "spatial": len(self.devices[0])}


def make_mesh(n_data: int | None = None, n_spatial: int = 1,
              devices=None) -> Mesh:
    """A ("data", "spatial") mesh over `devices`, by default every CUDA
    device (with no GPU that raises; pass CPU devices to run there):
    n_data x n_spatial of them in order, n_data by default as many as
    fit."""
    if devices is None:
        if not torch.cuda.is_available():
            raise unsupported("make_mesh: CUDA is not available; pass "
                              "devices to build a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_spatial
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial > len(devices):
        raise ValueError(f"a ({n_data}, {n_spatial}) mesh needs "
                         f"{n_data * n_spatial} devices, got {len(devices)}")
    return Mesh([devices[i * n_spatial:(i + 1) * n_spatial]
                 for i in range(n_data)])


def _check_row_shard(h: int, n_spatial: int, scale: int):
    rows = h // n_spatial
    if h % n_spatial or rows % 2 or rows % scale:
        raise ValueError(
            f"spatial sharding needs H ({h}) divisible by n_spatial "
            f"({n_spatial}) with an even per-shard row count divisible by "
            f"the gainmap scale ({scale})")


def _check_batch(b: int, n_data: int):
    if b % n_data:
        raise ValueError(f"a batch of {b} images does not divide over "
                         f"{n_data} data shards")


@dataclasses.dataclass
class Sharded:
    """A step's output left where it was computed: ``shards[d][s]`` is the
    tensor on mesh device (d, s), its axis 0 the images of data index d,
    its axis `row_axis` the rows of spatial index s (None: every spatial
    shard holds the same values)."""
    shards: list
    row_axis: int | None = 1

    def gather(self, device=None) -> torch.Tensor:
        """The shards concatenated along the row and batch axes on
        `device`, by default the first shard's."""
        if device is None:
            device = self.shards[0][0].device
        rows = [row[0].to(device) if self.row_axis is None
                else torch.cat([t.to(device) for t in row], self.row_axis)
                for row in self.shards]
        return torch.cat(rows, 0)


@dataclasses.dataclass
class _Shard:
    """One mesh position: its indices, device and side stream (None on the
    CPU)."""
    d: int
    s: int
    dev: torch.device
    stream: object = None

    def ctx(self):
        """Work queued under this context runs on the shard's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.dev))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def _shards(mesh: Mesh) -> list[list[_Shard]]:
    """The mesh's positions, each CUDA one with the next side stream of its
    device (the kernels' tables prepared on the device first), that stream
    ordered after the caller's current stream of the device, so that a
    shard reads what the caller queued before the step."""
    used: dict = {}
    out = []
    for d, row in enumerate(mesh.devices):
        out.append([])
        for s, dev in enumerate(row):
            stream = None
            if dev.type == "cuda":
                fused.prepare_device(dev)
                streams = fused.side_streams(dev)
                stream = streams[used.get(dev, 0) % len(streams)]
                used[dev] = used.get(dev, 0) + 1
                stream.wait_stream(torch.cuda.current_stream(dev))
            out[-1].append(_Shard(d, s, dev, stream))
    return out


def _copy(t: torch.Tensor, src: _Shard, dst: _Shard) -> torch.Tensor:
    """`t`, made on src's stream, as a tensor of its own on dst's device,
    queued on dst's stream after everything queued on src's so far (on one
    device `.to` would return `t` itself, which another shard must not
    share)."""
    if dst.stream is None:
        return t.to(dst.dev, copy=True)
    ready = torch.cuda.Event()
    ready.record(src.stream)
    with dst.ctx():
        dst.stream.wait_event(ready)
        # the copy reads `t` on the current stream of t's device
        t.record_stream(torch.cuda.current_stream(t.device))
        return t.to(dst.dev, copy=True, non_blocking=True)


def _finish(shards, *outputs):
    """The caller's current stream of each device waits for the shards'
    side streams, and every output is marked as used there."""
    for row in shards:
        for sh in row:
            if sh.stream is None:
                continue
            cur = torch.cuda.current_stream(sh.dev)
            cur.wait_stream(sh.stream)
            for out in outputs:
                out.shards[sh.d][sh.s].record_stream(cur)


def _upload(x, sh: _Shard, b: slice, rows: slice, row_axis: int = 1):
    """Shard `sh`'s block of a batch (numpy, or a tensor) on its device.
    From the host: one strided copy into pinned memory (the block of a (B,
    C, H, W) batch is not contiguous; ``np.ascontiguousarray`` first would
    copy it twice), then a copy queued on the current stream; 16- and
    32-bit integer samples travel as signed views of their patterns.  A
    tensor already on the device is copied there only where its block is
    not contiguous (the kernels read contiguous planes); a CUDA tensor is
    read on the shard's stream if it lies on the shard's device, so its
    memory is kept for that stream."""
    x = x[tuple([b] + [slice(None)] * (row_axis - 1) + [rows])]
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        x.record_stream(torch.cuda.current_stream(x.device))
    if isinstance(x, np.ndarray):
        if x.dtype.kind in "ui" and x.dtype.itemsize > 1:
            x = x.view(np.dtype(f"i{x.dtype.itemsize}"))
        if x.flags.writeable:
            x = torch.from_numpy(x)
    return pixel.to_device(x, sh.dev).contiguous()


def _blocks(n: int, parts: int, i: int) -> slice:
    k = n // parts
    return slice(i * k, (i + 1) * k)


def sharded_encode_step(mesh: Mesh, *, cg=ColorGamut.BT2100,
                        ct=ColorTransfer.HLG, rng=ColorRange.FULL,
                        scale: int = 4, multichannel: bool = True,
                        gamma: float = 1.0, two_pass: bool = True):
    """The multi-device API-0 encode step.

    step(y (B, H, W) u16, uv (B, H/2, W) u16), host arrays: B over "data",
    H over "spatial" -> Sharded (SDR Y, U, V, gain map) and for two-pass
    the log2 bounds (lo, hi), each (B, C) and the same on every spatial
    shard.  The two-pass min/max is reduced over the spatial shards of an
    image (the reference's cross-thread reduction, jpegr.cpp:838-931);
    images stay independent."""
    n_data, n_sp = mesh.shape["data"], mesh.shape["spatial"]
    kw = dict(cg=cg, ct=ct, rng=rng, scale=scale, multichannel=multichannel)

    def step(y, uv):
        b, h = y.shape[0], y.shape[1]
        _check_batch(b, n_data)
        _check_row_shard(h, n_sp, scale * 2)
        shards = _shards(mesh)
        outs = {}
        for row in shards:
            for sh in row:
                bs = _blocks(b, n_data, sh.d)
                with sh.ctx():
                    ys = _upload(y, sh, bs, _blocks(h, n_sp, sh.s))
                    uvs = _upload(uv, sh, bs, _blocks(h // 2, n_sp, sh.s))
                    per = [(fused.api0_p010_pixels(ys[i], uvs[i], gamma=gamma,
                                                   use_base_cg=True, **kw)
                            if not two_pass else
                            _twopass_front(ys[i], uvs[i], **kw))
                           for i in range(ys.shape[0])]
                    outs[sh.d, sh.s] = [torch.stack(o) for o in zip(*per)]
        if two_pass:
            for row in shards:
                _reduce_bounds(row, outs)
                for sh in row:
                    y8, u8, v8, gains, mm = outs[sh.d, sh.s]
                    with sh.ctx():
                        per = [_twopass_map(g, m[0], m[1], gamma)
                               for g, m in zip(gains, mm)]
                        outs[sh.d, sh.s] = [y8, u8, v8] + [
                            torch.stack(o) for o in zip(*per)]
        result = tuple(
            Sharded([[outs[sh.d, sh.s][k] for sh in row] for row in shards],
                    None if k >= 4 else (2 if k == 3 else 1))
            for k in range(6 if two_pass else 4))
        _finish(shards, *result)
        return result

    return step


def _reduce_bounds(row, outs):
    """The pmin / pmax over one image row's spatial shards: each shard's
    (B_local, 2, C) [min, max] goes to the row's first device, is reduced
    there and comes back; outs[(d, s)] ends (y8, u8, v8, gains, bounds)."""
    for sh in row:
        y8, u8, v8, gains, gmin, gmax = outs[sh.d, sh.s]
        with sh.ctx():
            outs[sh.d, sh.s] = [y8, u8, v8, gains,
                                torch.stack([gmin, gmax], 1)]
    if len(row) == 1:
        return
    head = row[0]
    parts = [_copy(outs[sh.d, sh.s][4], sh, head) for sh in row]
    with head.ctx():
        mm = torch.stack(parts)
        red = torch.stack([mm[:, :, 0].amin(0), mm[:, :, 1].amax(0)], 1)
    for sh in row:
        outs[sh.d, sh.s][4] = _copy(red, head, sh)


def sharded_encode_jpeg_step(mesh: Mesh, *, cg=ColorGamut.BT2100,
                             ct=ColorTransfer.HLG, rng=ColorRange.FULL,
                             scale: int = 4, multichannel: bool = False,
                             gamma: float = 1.0, quality: int = 95,
                             map_quality: int = 95,
                             use_base_cg: bool = False):
    """The multi-device API-0 encode with the DCT and the entropy pack.

    Every MCU row of both scans is a restart interval of its own, so each
    spatial shard packs its rows with no communication, and its blocks
    joined after the shards before it give the single-device scan byte for
    byte (``assemble_sharded_scan``).  Per shard and image: the pixel
    pipeline, the DCT, the stream glue and ONE launch of the pack kernel
    for both scans (``pack_kernel.PACK_KERNEL``, its plain version on the
    CPU).  Every shard's launches are queued before the word totals are
    read, so the devices do not wait for one another.

    step(y (B, H, W) u16, uv (B, H/2, W) u16) -> Sharded (base words,
    base blen, gain-map words, gain-map blen): each shard holds, per
    image, its scan's live words (u32 patterns as int32, zero-padded to the
    longest over the mesh) and its blocks' bit lengths (int32, no row pad).
    The per-shard rows must be a multiple of 16 and give whole gain-map
    MCU rows."""
    n_data, n_sp = mesh.shape["data"], mesh.shape["spatial"]

    def step(y, uv):
        b, h = y.shape[0], y.shape[1]
        _check_batch(b, n_data)
        h_shard = h // n_sp
        if h % n_sp or h_shard % 16 or (h_shard // scale) % 8:
            raise ValueError(
                f"per-shard rows ({h_shard}) must be a multiple of 16 and "
                f"yield whole gain-map MCU rows (scale {scale})")
        shards = _shards(mesh)
        packed = {}
        for row in shards:
            for sh in row:
                bs = _blocks(b, n_data, sh.d)
                with sh.ctx():
                    ys = _upload(y, sh, bs, _blocks(h, n_sp, sh.s))
                    uvs = _upload(uv, sh, bs, _blocks(h // 2, n_sp, sh.s))
                    packed[sh.d, sh.s] = [_pack_image(
                        ys[i], uvs[i], sh, cg=cg, ct=ct, rng=rng,
                        scale=scale, multichannel=multichannel, gamma=gamma,
                        quality=quality, map_quality=map_quality,
                        use_base_cg=use_base_cg)
                        for i in range(ys.shape[0])]
        # the one wait: every launch is queued
        totals = {k: [p.totals() for p in imgs]
                  for k, imgs in packed.items()}
        caps = [max(t[k] for ts in totals.values() for t in ts)
                for k in (0, 1)]
        outs = {}
        for row in shards:
            for sh in row:
                with sh.ctx():
                    outs[sh.d, sh.s] = [torch.stack(o) for o in zip(
                        *(p.live(t, caps) for p, t in zip(
                            packed[sh.d, sh.s], totals[sh.d, sh.s])))]
        packed.clear()          # the pack rooms go back to the allocator
        result = tuple(
            Sharded([[outs[sh.d, sh.s][k] for sh in row] for row in shards])
            for k in range(4))
        _finish(shards, *result)
        return result

    return step


@dataclasses.dataclass
class _PackedImage:
    """One image of one shard after its pack launch: the words (on the card
    the slot's room), the block lengths on the device, and on the card the
    slot whose pinned buffers receive the word total and the block lengths
    at `event`."""
    words: torch.Tensor
    blen: torch.Tensor
    n_base: int
    slot: fused._Slot | None = None
    event: torch.cuda.Event | None = None

    def totals(self) -> tuple[int, int]:
        """The base and gain-map scans' word counts (on the card, after
        waiting for the pack)."""
        if self.slot is None:
            blen_h, total = self.blen.numpy(), self.words.numel()
        else:
            self.event.synchronize()
            blen_h = self.slot.blen_h[:self.blen.numel()].numpy()
            total = int(self.slot.total_h[0])
        tb = device_entropy.total_words(blen_h[:self.n_base])
        return tb, total - tb

    def live(self, totals, caps):
        """(base words (caps[0],), base blen, gain-map words (caps[1],),
        gain-map blen): each scan's live words, zero-padded."""
        tb, tg = totals
        out = []
        for start, n, cap, bl in ((0, tb, caps[0], self.blen[:self.n_base]),
                                  (tb, tg, caps[1], self.blen[self.n_base:])):
            w = torch.zeros(cap, dtype=torch.int32, device=self.words.device)
            w[:n] = self.words[start:start + n]
            out += [w, bl]
        return out


def _pack_image(y, uv, sh: _Shard, *, quality: int, map_quality: int, **kw):
    """One image's pixel pipeline, DCT and stream glue, then one pack launch
    of both scans (``fused._pack_scans``).  On the card the launch goes
    into a slot of its own on the shard's stream (``fused._Slot.pack``:
    nothing waits for the card); on the CPU the plain version runs."""
    scans = fused._api0_p010_block_buffers(
        y, uv, quality=quality, map_quality=map_quality, **kw)
    lay = scans[0][1]
    n_base = lay.mcus_h * lay.bpr
    if sh.stream is None:
        return _PackedImage(*fused._pack_scans(scans, pack_kernel.pack_scan),
                            n_base)
    slot = fused._Slot(sh.dev, sh.stream)
    words, blen_h = fused._pack_scans(scans, slot.pack)
    event = fused.sleeping_event()
    event.record(sh.stream)
    return _PackedImage(words, slot.blen[:blen_h.numel()], n_base, slot,
                        event)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assemble_sharded_scan(words, blen, bpr: int) -> bytes:
    """Join one image's per-shard packed blocks into its final scan.

    words: (n_spatial, cap) or flat (n_spatial * cap,) u32 patterns (any
    integer carrier; tensors or host arrays), the shards' words of
    ``sharded_encode_jpeg_step``; blen: (n_spatial, blocks) or flat block
    bit lengths.  Each shard's live prefix follows the one before it, then
    ONE native join writes the byte-stuffed scan with a byte-aligned
    restart row and RST marker per MCU row: the single-device scan, since
    every restart row resets the DC predictor."""
    blen = _host(blen)
    n_spatial = blen.shape[0] if blen.ndim == 2 else 1
    blen = blen.reshape(n_spatial, -1)
    words = _host(words).view(np.uint32).reshape(n_spatial, -1)
    parts = []
    for s in range(n_spatial):
        need = device_entropy.total_words(blen[s])
        if need > words.shape[1]:
            raise device_entropy.PackOverflowError(
                f"shard {s} needs {need} words > budget {words.shape[1]}")
        pack_kernel.check_tile_budgets(blen[s], pack_kernel.CAP_WORDS)
        parts.append(words[s, :need])
    return native.join_blocks(np.concatenate(parts), blen.reshape(-1), bpr)


def sharded_apply_step(mesh: Mesh, *, scale_k: int = 1,
                       out_ct=ColorTransfer.HLG,
                       sdr_cg=ColorGamut.DISPLAY_P3,
                       hdr_cg=ColorGamut.BT2100, use_base_cg: bool = True,
                       weight: float = 1.0):
    """The multi-device decode apply step.

    step(sdr_yuv (B, 3, H, W) f32, gain (B, C, H/scale_k, W/scale_k) u8 or
    normalised f32, metadata arrays) -> Sharded packed outputs (B, H, W)
    int32 RGBA1010102 or (B, H, W, 4) int16 RGBAF16.  B over "data", rows
    over "spatial", one apply launch per image and shard.  At scale_k > 1
    the IDW needs one map row below each shard: the next shard's first map
    row, copied to the shard's device; the bottom shard uses its own last
    row with the bottom-edge tables.  The output equals the single-device
    apply bit for bit."""
    n_data, n_sp = mesh.shape["data"], mesh.shape["spatial"]

    def step(sdr_yuv, gain, meta):
        b, h = sdr_yuv.shape[0], sdr_yuv.shape[2]
        mh = gain.shape[2]
        _check_batch(b, n_data)
        if h % n_sp or mh % n_sp or (h // n_sp) != (mh // n_sp) * scale_k:
            raise ValueError(
                f"rows ({h}, map {mh}) do not split over {n_sp} spatial "
                f"shards of whole map rows at scale {scale_k}")
        shards = _shards(mesh)
        up = {}
        for row in shards:
            for sh in row:
                bs = _blocks(b, n_data, sh.d)
                with sh.ctx():
                    up[sh.d, sh.s] = (
                        _upload(sdr_yuv, sh, bs, _blocks(h, n_sp, sh.s), 2),
                        _upload(gain, sh, bs, _blocks(mh, n_sp, sh.s), 2))
        outs = {}
        for row in shards:
            for sh in row:
                sdr, g = up[sh.d, sh.s]
                halo, is_last = None, None
                if scale_k > 1 and n_sp > 1:
                    is_last = sh.s == n_sp - 1
                    nxt = row[min(sh.s + 1, n_sp - 1)]
                    halo = g[:, :, -1:, :] if is_last else \
                        _copy(up[nxt.d, nxt.s][1][:, :, :1, :], nxt, sh)
                with sh.ctx():
                    outs[sh.d, sh.s] = torch.stack([
                        apply_ops.apply_gainmap_core(
                            sdr[i], g[i], meta, scale_k=scale_k,
                            weight=np.float32(weight), out_ct=out_ct,
                            sdr_cg=sdr_cg, hdr_cg=hdr_cg,
                            use_base_cg=use_base_cg,
                            gain_halo_row=None if halo is None else halo[i],
                            edge_is_last=is_last)
                        for i in range(sdr.shape[0])])
        result = Sharded([[outs[sh.d, sh.s] for sh in row]
                          for row in shards])
        _finish(shards, result)
        return result

    return step
