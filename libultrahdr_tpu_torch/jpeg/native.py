"""ctypes bindings to the shared host entropy C++ that the encode slice needs.

The C++ is shared by path, not copied: ``libultrahdr_tpu/jpeg/_native/``
``jpeg_entropy.cpp`` and ``host_decode.cpp`` are compiled with the system
C++ compiler (UHDR_TPU_CXX, default g++) at first use into the port's
``_build/`` directory, for the generic target (no -march=native: the bound
functions are scalar integer code, and the library stays valid on any host
that finds it in ``_build/``).  Reading those source files imports nothing
of the JAX package.  Bound here:

- ``join_blocks``: the restart-row joiner (``uhdr_join_blocks``) that turns
  the device's word-aligned block segments into the final scan: bit-level
  concatenation, one byte-aligned restart row per MCU row, RST markers and
  byte stuffing in one sequential pass;
- ``decode_scan``: the baseline scan decoder, used by the checks to read the
  quantised coefficients back out of an encoded scan.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._buildlib import PKG_DIR, build_shared
from ..errors import UhdrError, UhdrErrorCode

_SRC_DIR = PKG_DIR.parent / "libultrahdr_tpu" / "jpeg" / "_native"
_SRCS = [_SRC_DIR / "jpeg_entropy.cpp", _SRC_DIR / "host_decode.cpp"]
_LOCK = threading.Lock()
_LIB = None


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            cxx = os.environ.get("UHDR_TPU_CXX", "g++")
            so, _ = build_shared(
                "jpeg_entropy", _SRCS,
                [cxx, "-O3", "-fno-math-errno", "-shared", "-fPIC",
                 "-std=c++17"])
            lib = ctypes.CDLL(str(so))
            lib.uhdr_join_blocks.restype = ctypes.c_int64
            lib.uhdr_join_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_decode_scan.restype = ctypes.c_int64
            lib.uhdr_decode_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            _LIB = lib
    return _LIB


def join_blocks(words: np.ndarray, len_bits: np.ndarray,
                blocks_per_row: int) -> bytes:
    """Bit-join word-aligned per-block segments into the final scan:
    concatenation + byte-aligned restart row and RST per MCU row + byte
    stuffing.  `len_bits` are per-block bit counts (u16) without row pad."""
    lib = get_lib()
    w = np.ascontiguousarray(words, np.uint32)
    lb = np.ascontiguousarray(len_bits, np.uint16)
    need = int(((lb.astype(np.int64) + 31) >> 5).sum())
    if w.size < need:
        raise ValueError(f"join_blocks: {w.size} words < {need} needed")
    total_bits = int(lb.astype(np.int64).sum())
    cap = total_bits // 4 + 2 * (lb.size // max(blocks_per_row, 1)) + 64
    out = np.empty(cap, np.uint8)
    written = lib.uhdr_join_blocks(w.ctypes.data, lb.ctypes.data,
                                   lb.size, blocks_per_row,
                                   out.ctypes.data, cap)
    if written < 0:
        raise RuntimeError(f"join_blocks failed: {written}")
    return out[:written].tobytes()


def _table_blobs(dc_tables, ac_tables):
    """Pack up to 4 HuffTables each into flat bits[4*16] / vals[4*256]."""
    dc_bits = np.zeros((4, 16), np.uint8)
    dc_vals = np.zeros((4, 256), np.uint8)
    ac_bits = np.zeros((4, 16), np.uint8)
    ac_vals = np.zeros((4, 256), np.uint8)
    for i, t in enumerate(dc_tables):
        if t is not None:
            dc_bits[i] = np.asarray(t.bits, np.uint8)
            dc_vals[i, :len(t.values)] = np.asarray(t.values, np.uint8)
    for i, t in enumerate(ac_tables):
        if t is not None:
            ac_bits[i] = np.asarray(t.bits, np.uint8)
            ac_vals[i, :len(t.values)] = np.asarray(t.values, np.uint8)
    return dc_bits, dc_vals, ac_bits, ac_vals


def decode_scan(data: bytes, comps, mcus_w: int, mcus_h: int, dc_tables,
                ac_tables, restart_interval: int = 0):
    """Decode one interleaved baseline scan (`data` starts right after the
    SOS header).  comps: [{h, v, dc_tbl, ac_tbl}, ...].  Returns
    ([(bh, bw, 64) int16 zigzag coefficients per component, MCU-padded],
    bytes consumed)."""
    lib = get_lib()
    for c in comps:
        if dc_tables[c["dc_tbl"]] is None or ac_tables[c["ac_tbl"]] is None:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "scan references a missing huffman table")
    n = len(comps)
    outs = [np.zeros((mcus_h * c["v"], mcus_w * c["h"], 64), np.int16)
            for c in comps]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in outs])
    meta = np.zeros((n, 6), np.int32)
    for i, c in enumerate(comps):
        meta[i] = [outs[i].shape[1], outs[i].shape[0], c["h"], c["v"],
                   c["dc_tbl"], c["ac_tbl"]]
    dcb, dcv, acb, acv = _table_blobs(dc_tables, ac_tables)
    buf = np.frombuffer(data, np.uint8)
    consumed = lib.uhdr_decode_scan(
        buf.ctypes.data, len(data), ptrs, meta.ctypes.data, n,
        mcus_w, mcus_h, restart_interval,
        dcb.ctypes.data, dcv.ctypes.data, acb.ctypes.data, acv.ctypes.data)
    if consumed < 0:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        f"entropy decode failed: {consumed}")
    return outs, int(consumed)
