"""Batched 8x8 DCTs in PyTorch: the forward DCT of the encode, built into
a whole scan's pack inputs, and the bit-exact islow IDCT of the decode.

Port of ``libultrahdr_tpu/jpeg/dct.py`` (and of the scan glue around its
forward DCT: the JAX ``fused._scan_coeffs``, ``_pad_edge``,
``_rgb_to_ycbcr`` and ``pack_kernel._stream_inputs``):

- ``forward_plane``: the level shift, the two 8-point passes, quantisation
  (round half to even, like libjpeg ISLOW's descale) and the zigzag
  reorder.  Each output of a pass is the sum of its 8 float32 products in
  index order, every product and sum rounded on its own, so a coefficient
  is the same sequence of rounded float32 operations whatever the plane's
  size and on any device: a row shard of an image gets its blocks'
  coefficients bit for bit (``parallel``), and the card gets the CPU's.  A
  batched matrix product does not: cuBLAS picks its kernel, and with it
  the rounding, by the batch size (``chip_smoke.py`` phase 17 counts the
  coefficients of an 8192x4608 luma plane that move when it is cut into 4
  row shards).  ``forward_plane_plain`` is that arithmetic as elementwise
  tensor ops.  The JAX package's HIGHEST-precision product sums in another
  order, so a quantised coefficient of the two packages may differ where
  it lies at a rounding tie.
- ``scan_inputs``: the scans of a request (``ScanPlanes`` and a
  ``ScanLayout`` each: unpadded u8 planes, an RGB source converted to
  YCbCr first) -> the pack kernel's inputs for all of them, back to back.
  Its plain version ``scan_inputs_plain`` is the composition ``pad_edge``
  -> ``rgb_to_ycbcr`` -> ``forward_plane_plain`` ->
  ``device_entropy.stream_inputs`` -> concatenation.  On the card both
  dispatchers launch ``csrc/dct_kernel.cu``, one launch a scan (a plane is
  a one-component scan in raster order), which equals the plain version
  bit for bit; ``FORWARD_DCT_KERNEL`` counts the launches.
- ``fdct8x8`` / ``idct8x8`` and ``blockify`` / ``pad_to_block_multiple``:
  the float DCT pair of the reference's exported math surface (no encode
  or decode runs them).
- ``inverse_plane``: dequantisation, libjpeg's jpeg_idct_islow butterfly and
  its range-limit table, entirely in int32 tensor ops.  torch's int32
  arithmetic wraps in two's complement on the CPU and on CUDA, ``>>`` on
  int32 is an arithmetic shift and ``&`` acts on the two's-complement
  pattern, so the result equals libjpeg (and the JAX package) bit for bit,
  including on adversarial coefficients whose products overflow int32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported
from ..ops.pixel import to_device
from . import device_entropy
from .tables import INV_ZIGZAG, ZIGZAG_ORDER


@functools.lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D.

    The separable orthonormal 2-D transform D x D^T equals the T.81 Annex A
    FDCT exactly (the 1/4 C(u)C(v) normalization is the product of the two
    1-D scale factors), so quant tables apply directly."""
    k = np.arange(8)
    d = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    d[0, :] = np.sqrt(1.0 / 8.0)
    return d.astype(np.float32)


def pad_to_block_multiple(plane: torch.Tensor, fill=None) -> torch.Tensor:
    """Pad (H, W) to multiples of 8 by edge replication (fill overrides)."""
    h, w = plane.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    if fill is None:
        return pad_edge(plane, ph, pw)
    out = torch.full((ph, pw), fill, dtype=plane.dtype, device=plane.device)
    out[:h, :w] = plane
    return out


def blockify(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (bh, bw, 8, 8); H, W must be multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def fdct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2-D DCT on float (..., 8, 8): D @ x @ D^T."""
    d = to_device(dct_matrix(), blocks.device).to(blocks.dtype)
    return d @ blocks @ d.T


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT on float (..., 8, 8): D^T @ X @ D (float reference
    form)."""
    d = to_device(dct_matrix(), coeffs.device).to(coeffs.dtype)
    return d.T @ coeffs @ d


def pad_edge(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate pad of an (h, w) plane to (ph, pw), any dtype."""
    h, w = p.shape
    if h == ph and w == pw:
        return p
    rows = torch.arange(ph, device=p.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=p.device).clamp(max=w - 1)
    return p.index_select(0, rows).index_select(1, cols)


def rgb_to_ycbcr(rgb_u8_chw):
    """libjpeg full-range Rec.601 RGB->YCbCr (jccolor.c) on (3, H, W) (or
    three (H, W) planes)."""
    r, g, b = (rgb_u8_chw[i].to(torch.float32) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return [torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)
            for p in (y, cb, cr)]


def forward_plane_plain(plane_u8: torch.Tensor,
                        qtable_natural) -> torch.Tensor:
    """Plain version of the forward DCT (any device): uint8 (H, W) plane, H
    and W multiples of 8 -> zigzagged quantized coefficients (H/8, W/8, 64)
    int16.  Level shift -128, FDCT, quantize, zigzag reorder."""
    dev = plane_u8.device
    x = plane_u8.to(torch.float32) - 128.0
    h, w = x.shape
    blocks = x.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
    d = to_device(dct_matrix(), dev)
    # D X: rows of the block; then (D X) D^T: its columns
    t = d[:, 0, None] * blocks[..., 0:1, :]
    for k in range(1, 8):
        t = t + d[:, k, None] * blocks[..., k:k + 1, :]
    coeffs = t[..., 0:1] * d[:, 0]
    for k in range(1, 8):
        coeffs = coeffs + t[..., k:k + 1] * d[:, k]
    q = to_device(np.asarray(qtable_natural, np.float32).reshape(8, 8), dev)
    quant = torch.round(coeffs / q).to(torch.int16)
    flat = quant.reshape(h // 8, w // 8, 64)
    return flat[..., to_device(np.asarray(ZIGZAG_ORDER, np.int64), dev)]


class ScanPlanes(NamedTuple):
    """A scan's sources: its components' unpadded uint8 (h, w) planes in
    the order of the layout's sampling (for ``rgb``, the R, G and B planes
    of a 4:4:4 scan, converted to Y, Cb, Cr) and each component's
    quantisation table in natural order."""

    planes: list
    qtables: list
    rgb: bool = False


def scan_coeffs_plain(src: ScanPlanes, layout) -> list:
    """The scan's zigzagged (bh, bw, 64) int16 coefficient planes, each
    component edge-padded to whole MCUs (plain version)."""
    planes = rgb_to_ycbcr(src.planes) if src.rgb else src.planes
    return [forward_plane_plain(
                pad_edge(p, layout.mcus_h * vs * 8, layout.mcus_w * hs * 8),
                q)
            for p, (hs, vs), q in zip(planes, layout.sampling, src.qtables)]


def scan_inputs_plain(scans):
    """Plain version of ``scan_inputs``: each scan's stream inputs, then one
    concatenation."""
    parts = [device_entropy.stream_inputs(scan_coeffs_plain(src, lay), lay)
             for src, lay in scans]
    return tuple(torch.cat(p) for p in zip(*parts))


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
DCT_LIB = CudaLibrary("dct_kernel", {
    "uhdr_build_scan": [_PTR, ctypes.c_int, _PTR, _PTR, _PTR, _PTR]})
_MAX_BLOCKS = 10


class _ScanParams(ctypes.Structure):
    """csrc/dct_kernel.cu ScanParams."""
    _fields_ = [("d", ctypes.c_float * 64),
                ("q", (ctypes.c_float * 64) * 3),
                ("pos", ctypes.c_int * 64),
                ("src", _PTR * 3), ("stride", _I64 * 3),
                ("h", ctypes.c_int * 3), ("w", ctypes.c_int * 3),
                ("hs", ctypes.c_int * 3), ("vs", ctypes.c_int * 3),
                ("comp_of", ctypes.c_int * _MAX_BLOCKS),
                ("prev_of", ctypes.c_int * _MAX_BLOCKS),
                ("first_of", ctypes.c_int * _MAX_BLOCKS),
                ("n_comp", ctypes.c_int), ("mcus_w", ctypes.c_int),
                ("mcus_h", ctypes.c_int), ("bpm", ctypes.c_int),
                ("bpr", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _scan_params(sampling: tuple, mcus_w: int, mcus_h: int,
                 q: bytes) -> bytes:
    """The launch-independent part of a scan's ScanParams (D, the tables,
    the zigzag positions, the MCU's blocks and their DC predecessors), as
    bytes to copy from."""
    p = _ScanParams()
    p.d[:] = dct_matrix().ravel().tolist()
    for c, row in enumerate(np.frombuffer(q, np.float32).reshape(-1, 64)):
        p.q[c][:] = row.tolist()
    p.pos[:] = np.asarray(INV_ZIGZAG).tolist()
    b = 0
    for c, (hs, vs) in enumerate(sampling):
        p.hs[c], p.vs[c] = hs, vs
        n = hs * vs
        for i in range(n):
            p.comp_of[b + i] = c
            p.first_of[b + i] = i == 0
            p.prev_of[b + i] = b + (n - 1 if i == 0 else i - 1)
        b += n
    p.n_comp, p.mcus_w, p.mcus_h, p.bpm = len(sampling), mcus_w, mcus_h, b
    p.bpr = b * mcus_w
    return bytes(p)


class _ForwardDctKernel:
    """Wrapper of csrc/dct_kernel.cu: checks, one launch a scan, and the
    launch count."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def _check(src: ScanPlanes, layout):
        planes = src.planes
        dev = planes[0].device
        n = len(layout.sampling)
        if dev.type != "cuda":
            raise ValueError(f"forward DCT kernel needs CUDA tensors, got "
                             f"{dev}")
        if len(planes) != n or len(src.qtables) != n or n > 3 or (
                src.rgb and (n != 3 or any(
                    s != (1, 1) for s in layout.sampling))):
            raise ValueError(f"forward DCT kernel: {len(planes)} planes and "
                             f"{len(src.qtables)} tables for sampling "
                             f"{layout.sampling} (rgb={src.rgb})")
        if layout.bpr * layout.mcus_w and layout.bpr // layout.mcus_w > \
                _MAX_BLOCKS:
            raise ValueError(f"forward DCT kernel: more than {_MAX_BLOCKS} "
                             f"blocks an MCU in {layout.sampling}")
        out = []
        for p in planes:
            if p.device != dev or p.dtype != torch.uint8 or p.dim() != 2 \
                    or 0 in p.shape:
                raise ValueError(
                    f"forward DCT kernel: the planes must be non-empty uint8 "
                    f"(H, W) on {dev}, got {p.dtype} {tuple(p.shape)} on "
                    f"{p.device}")
            if src.rgb and p.shape != planes[0].shape:
                raise ValueError("forward DCT kernel: R, G and B planes of "
                                 "different sizes")
            out.append(p if p.stride(1) == 1 else p.contiguous())
        return out

    def scan(self, src: ScanPlanes, layout, stream: torch.Tensor,
             dc_diff: torch.Tensor | None = None,
             is_luma: torch.Tensor | None = None):
        """One launch: the scan's pack inputs into `stream` ((n, 64) int16)
        and, when given, `dc_diff` and `is_luma` ((n,) int32), n the scan's
        block count, on the planes' device and current stream."""
        planes = self._check(src, layout)
        n = layout.mcus_h * layout.bpr
        for t, dtype, shape in ((stream, torch.int16, (n, 64)),
                                (dc_diff, torch.int32, (n,)),
                                (is_luma, torch.int32, (n,))):
            if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                                  or t.device != planes[0].device
                                  or not t.is_contiguous()):
                raise ValueError(f"forward DCT kernel: output {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}, expected "
                                 f"{dtype} {shape} on {planes[0].device}")
        if (dc_diff is None) != (is_luma is None):
            raise ValueError("forward DCT kernel: dc_diff and is_luma go "
                             "together")
        if stream.data_ptr() % 16:
            raise ValueError("forward DCT kernel: stream not 16-byte aligned")
        q = np.stack([np.asarray(t, np.float32).reshape(64)
                      for t in src.qtables])
        p = _ScanParams.from_buffer_copy(_scan_params(
            tuple(layout.sampling), layout.mcus_w, layout.mcus_h,
            q.tobytes()))
        for c, t in enumerate(planes):
            p.src[c], p.stride[c] = t.data_ptr(), t.stride(0)
            p.h[c], p.w[c] = t.shape
        lib = DCT_LIB.build()
        check_launch(lib, lib.uhdr_build_scan(
            ctypes.byref(p), int(src.rgb), stream.data_ptr(),
            None if dc_diff is None else dc_diff.data_ptr(),
            None if is_luma is None else is_luma.data_ptr(),
            torch.cuda.current_stream(planes[0].device).cuda_stream),
            "uhdr_build_scan")
        self.launches += 1

    def __call__(self, plane_u8: torch.Tensor,
                 qtable_natural) -> torch.Tensor:
        """The coefficients of one plane, H and W multiples of 8: a
        one-component scan in raster order."""
        if plane_u8.dim() != 2 or plane_u8.shape[0] % 8 \
                or plane_u8.shape[1] % 8:
            raise ValueError(
                f"forward DCT kernel: the plane must be (H, W) with H and W "
                f"multiples of 8, got {tuple(plane_u8.shape)}")
        h, w = plane_u8.shape
        layout = device_entropy.scan_layout(((1, 1),), w // 8, h // 8)
        out = torch.empty((h // 8 * (w // 8), 64), dtype=torch.int16,
                          device=plane_u8.device)
        self.scan(ScanPlanes([plane_u8], [qtable_natural]), layout, out)
        return out.reshape(h // 8, w // 8, 64)


FORWARD_DCT_KERNEL = _ForwardDctKernel()


def forward_plane(plane_u8: torch.Tensor, qtable_natural) -> torch.Tensor:
    """Dispatcher: uint8 (H, W) plane, H and W multiples of 8 -> zigzagged
    quantized coefficients (H/8, W/8, 64) int16; the plain version for a
    CPU tensor, the CUDA kernel for a CUDA one.  No fallback between the
    two."""
    if plane_u8.device.type == "cpu":
        return forward_plane_plain(plane_u8, qtable_natural)
    if plane_u8.device.type == "cuda":
        return FORWARD_DCT_KERNEL(plane_u8, qtable_natural)
    raise unsupported(f"no forward DCT for device {plane_u8.device}")


def scan_inputs(scans):
    """Dispatcher: [(ScanPlanes, ScanLayout), ...] -> the pack inputs of
    all scans back to back (stream (n, 64) int16 in MCU stream order,
    dc_diff (n,) int32 with the predictor reset every MCU row, is_luma (n,)
    int32).  CPU planes: the plain version; CUDA planes: one kernel launch
    a scan, each writing its part of the three preallocated outputs.  No
    fallback between the two."""
    dev = scans[0][0].planes[0].device
    if dev.type == "cpu":
        return scan_inputs_plain(scans)
    if dev.type != "cuda":
        raise unsupported(f"no scan build for device {dev}")
    counts = [lay.mcus_h * lay.bpr for _, lay in scans]
    total = sum(counts)
    stream = torch.empty((total, 64), dtype=torch.int16, device=dev)
    dc_diff = torch.empty(total, dtype=torch.int32, device=dev)
    is_luma = torch.empty(total, dtype=torch.int32, device=dev)
    off = 0
    for (src, lay), n in zip(scans, counts):
        FORWARD_DCT_KERNEL.scan(src, lay, stream[off:off + n],
                                dc_diff[off:off + n], is_luma[off:off + n])
        off += n
    return stream, dc_diff, is_luma


def unblockify(blocks: torch.Tensor) -> torch.Tensor:
    """(bh, bw, 8, 8) -> (bh*8, bw*8)."""
    bh, bw = blocks.shape[0], blocks.shape[1]
    return blocks.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)


# Loeffler-Ligtenberg-Moshovitz fixed-point constants at CONST_BITS=13, the
# scaled 13-bit roundings of every libjpeg islow build: round(f * 8192)
_K0_298631336 = 2446
_K0_390180644 = 3196
_K0_541196100 = 4433
_K0_765366865 = 6270
_K0_899976223 = 7373
_K1_175875602 = 9633
_K1_501321110 = 12299
_K1_847759065 = 15137
_K1_961570560 = 16069
_K2_053119869 = 16819
_K2_562915447 = 20995
_K3_072711026 = 25172


def _islow_butterfly(s):
    """One 1-D islow pass over 8 parallel int32 tensors, WITHOUT the final
    descale: the 8 outputs scaled by 2^13 relative to the inputs, in
    libjpeg's int32 operation sequence (so any wrap-around matches it)."""
    s0, s1, s2, s3, s4, s5, s6, s7 = s
    # even part
    z1 = (s2 + s6) * _K0_541196100
    e2 = z1 - s6 * _K1_847759065
    e3 = z1 + s2 * _K0_765366865
    e0 = (s0 + s4) * 8192
    e1 = (s0 - s4) * 8192
    t10, t13 = e0 + e3, e0 - e3
    t11, t12 = e1 + e2, e1 - e2
    # odd part
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = t0 + t2, t1 + t3
    z5 = (z3 + z4) * _K1_175875602
    t0 = t0 * _K0_298631336
    t1 = t1 * _K2_053119869
    t2 = t2 * _K3_072711026
    t3 = t3 * _K1_501321110
    z1 = z1 * -_K0_899976223
    z2 = z2 * -_K2_562915447
    z3 = z3 * -_K1_961570560 + z5
    z4 = z4 * -_K0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    """libjpeg DESCALE: round-half-up arithmetic shift."""
    return (x + (1 << (n - 1))) >> n


def idct8x8_islow(deq: torch.Tensor) -> torch.Tensor:
    """Bit-exact libjpeg jpeg_idct_islow on int32 dequantised blocks
    (..., 8, 8) -> int32 spatial samples (callers add 128 and range-limit).
    Pass 1 over columns keeps PASS1_BITS=2 (descale 11), pass 2 over rows
    descales by 18."""
    t = _islow_butterfly([deq[..., u, :] for u in range(8)])
    t = torch.stack([_descale(x, 11) for x in t], dim=-2)
    o = _islow_butterfly([t[..., :, v] for v in range(8)])
    return torch.stack([_descale(x, 18) for x in o], dim=-1)


def range_limit(sample: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range_limit table (jdmaster.c
    prepare_range_limit_table) in closed form over `sample` = IDCT output
    + 128: m = sample & 1023 (two's complement, so negatives wrap mod
    1024), then m < 256 -> m, m < 640 -> 255, else 0."""
    m = sample & 1023
    return torch.where(m < 256, m, torch.where(m < 640, 255, 0))


def inverse_plane(zz_coeffs: torch.Tensor, qtable_natural,
                  out_h: int, out_w: int) -> torch.Tensor:
    """(bh, bw, 64) int16 zigzag coefficients -> uint8 (out_h, out_w) plane,
    bit-identical to libjpeg's islow decode."""
    dev = zz_coeffs.device
    inv = to_device(np.asarray(INV_ZIGZAG, np.int64), dev)
    q = to_device(np.asarray(qtable_natural, np.int32).reshape(64), dev)
    deq = zz_coeffs[..., inv].to(torch.int32) * q
    spatial = idct8x8_islow(deq.reshape(*deq.shape[:-1], 8, 8)) + 128
    plane = unblockify(range_limit(spatial).to(torch.uint8))
    return plane[:out_h, :out_w]
