"""Batched 8x8 DCTs in PyTorch: the forward float DCT of the encode and the
bit-exact islow IDCT of the decode.

Port of ``libultrahdr_tpu/jpeg/dct.py``:

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
  tensor ops; on the card ``forward_plane`` launches
  ``csrc/dct_kernel.cu``, the same arithmetic in one kernel.  The JAX
  package's HIGHEST-precision product sums in another order, so a
  quantised coefficient of the two packages may differ where it lies at a
  rounding tie.
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

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported
from ..ops.pixel import to_device
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


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
DCT_LIB = CudaLibrary("dct_kernel", {
    "uhdr_forward_dct": [_PTR, _I64, _I64, _PTR, _PTR, _PTR]})


class _DctParams(ctypes.Structure):
    """csrc/dct_kernel.cu DctParams: D row-major, the quantisation table in
    natural order, each natural index's zigzag position."""
    _fields_ = [("d", ctypes.c_float * 64), ("q", ctypes.c_float * 64),
                ("pos", ctypes.c_int * 64)]


@functools.lru_cache(maxsize=16)
def _dct_params(q: bytes) -> _DctParams:
    params = _DctParams()
    params.d[:] = dct_matrix().ravel().tolist()
    params.q[:] = np.frombuffer(q, np.float32).tolist()
    params.pos[:] = np.asarray(INV_ZIGZAG).tolist()
    return params


class _ForwardDctKernel:
    """Wrapper of csrc/dct_kernel.cu: launch and launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, plane_u8: torch.Tensor,
                 qtable_natural) -> torch.Tensor:
        dev = plane_u8.device
        if dev.type != "cuda":
            raise ValueError(f"forward DCT kernel needs a CUDA tensor, got "
                             f"{dev}")
        if (plane_u8.dim() != 2 or plane_u8.dtype != torch.uint8
                or plane_u8.shape[0] % 8 or plane_u8.shape[1] % 8):
            raise ValueError(
                f"forward DCT kernel: the plane must be uint8 (H, W) with H "
                f"and W multiples of 8, got {plane_u8.dtype} "
                f"{tuple(plane_u8.shape)}")
        if not plane_u8.is_contiguous() or plane_u8.data_ptr() % 8:
            plane_u8 = plane_u8.clone(memory_format=torch.contiguous_format)
        h, w = plane_u8.shape
        q = np.ascontiguousarray(np.asarray(qtable_natural, np.float32)
                                 .reshape(64))
        out = torch.empty((h // 8, w // 8, 64), dtype=torch.int16,
                          device=dev)
        lib = DCT_LIB.build()
        check_launch(lib, lib.uhdr_forward_dct(
            plane_u8.data_ptr(), h, w, ctypes.byref(_dct_params(q.tobytes())),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "uhdr_forward_dct")
        self.launches += 1
        return out


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
