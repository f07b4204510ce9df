"""Huffman symbol generation, bit packing and compaction of JPEG blocks.

Port of the Pallas TPU kernel ``libultrahdr_tpu/jpeg/pack_kernel.py``
``_pack_tiles_v3`` (entry ``pack_scan_tiles``), in three pieces:

- ``pack_scan_plain``: the plain PyTorch version.  Bit math in int64
  (torch's uint32 op coverage is thin); the tests hold it against the TPU
  kernel in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel
  against it on the card.
- ``PACK_KERNEL``: the wrapper of the hand-written CUDA kernel
  ``csrc/pack_kernel.cu`` (see its header for the design and what bounds it
  on the H100).  It builds the kernel with nvcc for sm_90a at first use into
  ``_build/``, launches it on PyTorch's current stream, raises on a refused
  launch, and counts its launches in ``PACK_KERNEL.launches``.
- ``pack_scan``: the dispatcher.  A CPU tensor goes to the plain version, a
  CUDA tensor to the kernel; anything else raises.  Nothing falls back: a
  failed build or launch propagates.

All three take the stream inputs of ``device_entropy.stream_inputs``
(stream (n, 64) int16 zigzag coefficients in MCU stream order, dc_diff (n,)
int32, is_luma (n,) int32) and return (words (total,) int32 holding u32 bit
patterns, blen (n,) int32).  Block b's MSB-first bitstream sits word-aligned
at the exclusive prefix sum of ceil(blen/32); blen has no restart-row pad.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .._buildlib import PKG_DIR, build_cuda, check_launch
from ..errors import unsupported
from .tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA


@functools.lru_cache(maxsize=1)
def packed_luts() -> np.ndarray:
    """(544,) u32 Huffman table, code << 5 | length, laid out
    [DC luma 16][DC chroma 16][AC luma 256][AC chroma 256] (the DC tables'
    entries 12..15 are unused categories, zero like the TPU kernel's)."""
    def packed(t, n):
        return (np.asarray(t.code_of[:n], np.uint32) << 5) \
            | np.asarray(t.size_of[:n], np.uint32)
    return np.concatenate([packed(DC_LUMA, 16), packed(DC_CHROMA, 16),
                           packed(AC_LUMA, 256), packed(AC_CHROMA, 256)])


def _bit_size(v: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category of int64 values, capped at 15 like the TPU
    kernel's 15-compare _bit_size_vec: frexp's exponent is bit_length(|v|)
    exactly for |v| < 2^24."""
    e = torch.frexp(v.abs().to(torch.float32)).exponent.to(torch.int64)
    return e.clamp(max=15)


def _value_bits(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """One's-complement style extra bits (T.81 F.1.2.1), int64."""
    one = torch.ones_like(size)
    x = torch.where(v < 0, v + (one << size) - 1, v)
    return x & ((one << size) - 1)


def _u32_bits_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_scan_plain(stream: torch.Tensor, dc_diff: torch.Tensor,
                    is_luma: torch.Tensor):
    """Plain PyTorch version of the pack kernel (any device).

    Every block gets 65 slots [DC, 63 AC positions (a ZRL or a code, never
    both), EOB] of (payload, length); the in-block exclusive scan of the
    lengths and the block's word offset give each slot's absolute bit
    position, and each slot (<= 26 bits) lands in at most two words through
    two index_adds (the bit ranges are disjoint, so add == or)."""
    dev = stream.device
    n = stream.shape[0]
    lut = torch.from_numpy(packed_luts().astype(np.int64)).to(dev)
    code, length = lut >> 5, lut & 31
    chroma = (is_luma == 0).to(torch.int64)              # (n,) table row
    dc_base = chroma * 16
    ac_base = 32 + chroma * 256

    # ---- DC slot --------------------------------------------------------
    d = dc_diff.to(torch.int64)
    ds = _bit_size(d)
    dc_pay = (code[dc_base + ds] << ds) | _value_bits(d, ds)
    dc_len = length[dc_base + ds] + ds

    # ---- AC slots -------------------------------------------------------
    ac = stream[:, 1:].to(torch.int64)                   # (n, 63)
    nz = ac != 0
    k = torch.arange(1, 64, dtype=torch.int64, device=dev)
    incl = torch.cummax(torch.where(nz, k, 0), dim=1).values
    prev_nz = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    last_nz = incl[:, -1:]
    zrl_on = ~nz & ((k - prev_nz) % 16 == 0) & (k < last_nz)
    run = (k - prev_nz - 1) % 16
    asz = _bit_size(ac)
    sym = ac_base[:, None] + torch.where(nz, (run << 4) | asz, 0)
    zrl = ac_base[:, None] + 0xF0
    ac_pay = torch.where(nz, (code[sym] << asz) | _value_bits(ac, asz),
                         torch.where(zrl_on, code[zrl], 0))
    ac_len = torch.where(nz, length[sym] + asz,
                         torch.where(zrl_on, length[zrl], 0))

    eob_on = last_nz[:, 0] < 63
    eob_pay = torch.where(eob_on, code[ac_base], 0)
    eob_len = torch.where(eob_on, length[ac_base], 0)

    pays = torch.cat([dc_pay[:, None], ac_pay, eob_pay[:, None]], dim=1)
    lens = torch.cat([dc_len[:, None], ac_len, eob_len[:, None]], dim=1)

    # ---- placement ------------------------------------------------------
    blen = lens.sum(dim=1)
    wlen = (blen + 31) >> 5
    dest = torch.cumsum(wlen, 0) - wlen
    total = int(wlen.sum())
    bitpos = dest[:, None] * 32 + torch.cumsum(lens, 1) - lens
    w = (bitpos >> 5).reshape(-1)
    s = (bitpos & 31).reshape(-1)
    msb = (pays << (32 - lens)).reshape(-1)              # MSB-aligned u32
    hi = msb >> s
    lo = (msb & ((torch.ones_like(s) << s) - 1)) << (32 - s)
    words = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, w, hi)
    words.index_add_(0, w + 1, lo)
    return _u32_bits_as_i32(words[:total]), blen.to(torch.int32)


class _PackKernel:
    """Wrapper of csrc/pack_kernel.cu: build at first use, per-device
    tables, launch, launch count."""

    SOURCE = PKG_DIR / "csrc" / "pack_kernel.cu"

    def __init__(self):
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None
        self._luts: dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    def build(self):
        """Compile (or load the cached) kernel library; returns it."""
        with self._lock:
            if self._lib is None:
                lib, self.build_log, self.build_seconds = build_cuda(
                    "pack_kernel", self.SOURCE)
                args = [ctypes.c_void_p] * 4
                lib.uhdr_pack_blen.argtypes = args + [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
                lib.uhdr_pack_blen.restype = ctypes.c_int
                lib.uhdr_pack_words.argtypes = args + [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_void_p]
                lib.uhdr_pack_words.restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def _lut(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._luts:
            self._luts[dev] = torch.from_numpy(
                packed_luts().view(np.int32)).to(dev)
        return self._luts[dev]

    def __call__(self, stream: torch.Tensor, dc_diff: torch.Tensor,
                 is_luma: torch.Tensor):
        dev = stream.device
        n = stream.shape[0]
        if dev.type != "cuda":
            raise ValueError(f"pack kernel needs CUDA tensors, got {dev}")
        for name, t, dtype, shape in (
                ("stream", stream, torch.int16, (n, 64)),
                ("dc_diff", dc_diff, torch.int32, (n,)),
                ("is_luma", is_luma, torch.int32, (n,))):
            if (t.device != dev or t.dtype != dtype
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"pack kernel: {name} must be a contiguous {dtype} "
                    f"{shape} tensor on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if stream.data_ptr() % 16:
            raise ValueError("pack kernel: stream must be 16-byte aligned")
        lib = self.build()
        lut = self._lut(dev)
        cs = torch.cuda.current_stream(dev).cuda_stream
        blen = torch.empty(n, dtype=torch.int32, device=dev)
        check_launch(lib, lib.uhdr_pack_blen(
            stream.data_ptr(), dc_diff.data_ptr(), is_luma.data_ptr(),
            lut.data_ptr(), blen.data_ptr(), n, cs), "uhdr_pack_blen")
        wlen = (blen.to(torch.int64) + 31) >> 5
        dest = torch.cumsum(wlen, 0) - wlen
        total = int(wlen.sum())
        words = torch.empty(total, dtype=torch.int32, device=dev)
        check_launch(lib, lib.uhdr_pack_words(
            stream.data_ptr(), dc_diff.data_ptr(), is_luma.data_ptr(),
            lut.data_ptr(), dest.data_ptr(), words.data_ptr(), n, cs),
            "uhdr_pack_words")
        self.launches += 1
        return words, blen


PACK_KERNEL = _PackKernel()


def pack_scan(stream: torch.Tensor, dc_diff: torch.Tensor,
              is_luma: torch.Tensor):
    """Dispatcher: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors.  No fallback between the two."""
    if stream.device.type == "cpu":
        return pack_scan_plain(stream, dc_diff, is_luma)
    if stream.device.type == "cuda":
        return PACK_KERNEL(stream, dc_diff, is_luma)
    raise unsupported(f"no pack implementation for device {stream.device}")
