"""ctypes bindings to the port's host C++.

The port keeps its own copy of the JAX package's native sources,
``csrc/host/jpeg_entropy.cpp`` and ``csrc/host/host_decode.cpp`` (identical
in code, so the host stages of both packages agree bit for bit).  They are
compiled with the system C++ compiler (UHDR_TPU_CXX, default g++) at first
use into the port's ``_build/`` directory with the JAX package's flags
(``-O3 -march=native -fno-math-errno``): the host decode engine's float
IDCT and apply take their AVX2/FMA and AVX-512 branches exactly where the
JAX package's build does, so ``JpegR.decode_host`` gives the JAX package's
bytes on the same host.  The library's key holds a hash of the compiler's
``-march=native`` target macros, so a ``_build/`` copied to another host is
rebuilt there rather than loaded.  Bound here:

- ``join_blocks``: the restart-row joiner (``uhdr_join_blocks``) that turns
  the device's word-aligned block segments into the final scan: bit-level
  concatenation, one byte-aligned restart row per MCU row, RST markers and
  byte stuffing in one sequential pass;
- ``decode_scan``: the baseline scan decoder (the decode's host Huffman
  stage, and the checks' reader of an encoded scan's coefficients);
- ``decode_progressive_scan``: one progressive SOS (T.81 G.2) into shared
  coefficient arrays;
- ``encode_scan``: the general path's host entropy coder
  (``uhdr_encode_scan``): one interleaved baseline scan from quantised
  coefficient planes, with byte stuffing and optional restart markers;
- the host decode engine (``JpegR.decode_host``): ``idct_plane`` (AAN float
  IDCT to u8), ``ycbcr_to_rgb_planar`` (a 3-channel gain map's colour
  decode) and ``apply_gainmap_host`` (IDW, gain, OETF and packing in one
  pass);
- the wire codecs' host halves (``wire.py``): ``pack_p010_10bit`` (the
  dense 10-bit fallback), ``pack_delta_into`` / ``pack_delta7_into`` /
  ``pack_delta7`` (the P010 delta rungs), ``pack_delta_g_into`` (the RGB
  and SDR rungs), ``pack_vw_into`` (the variable-width group wire),
  ``pack_slices_into`` (the coefficient bit-slice rungs),
  ``extract_channel10`` (an RGBA1010102 channel) and ``unpack_delta2d``
  (the download wire's host half).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .._buildlib import PKG_DIR, build_shared
from ..errors import UhdrError, UhdrErrorCode

_SRC_DIR = PKG_DIR / "csrc" / "host"
_SRCS = [_SRC_DIR / "jpeg_entropy.cpp", _SRC_DIR / "host_decode.cpp"]
# the JAX package's flags (libultrahdr_tpu/jpeg/native.py)
_FLAGS = ["-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC",
          "-std=c++17"]
# UHDR_TPU_SANITIZE=1: the JAX package's ASan + UBSan build, under a name
# of its own; a process loads it only with libasan preloaded
# (tools/sanitize_replay.py arranges that)
_SANITIZE_FLAGS = ["-O1", "-g", "-march=native",
                   "-fsanitize=address,undefined",
                   "-fno-sanitize-recover=all", "-shared", "-fPIC",
                   "-std=c++17"]
_LOCK = threading.Lock()
_LIB = None


def _host_target(cxx: str) -> str:
    """The compiler's predefined macros under -march=native: the host's
    instruction set as the build sees it."""
    proc = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                           "-"], input="", capture_output=True, text=True,
                          check=True)
    return hashlib.sha256(proc.stdout.encode()).hexdigest()


def cxx() -> str:
    """The C++ compiler of the host library (UHDR_TPU_CXX, default g++)."""
    return os.environ.get("UHDR_TPU_CXX", "g++")


def sanitize() -> bool:
    """UHDR_TPU_SANITIZE=1 (the JAX package's knob): build and load the
    ASan + UBSan variant."""
    return os.environ.get("UHDR_TPU_SANITIZE") == "1"


def build_args() -> tuple:
    """The host library's (name, sources, command, key) for
    ``_buildlib.build_shared``: the key is the host's ``_host_target``.
    With ``sanitize()`` the library is ``jpeg_entropy_asan`` built with
    ``-O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all``."""
    compiler = cxx()
    if sanitize():
        return ("jpeg_entropy_asan", _SRCS, [compiler, *_SANITIZE_FLAGS],
                _host_target(compiler))
    return ("jpeg_entropy", _SRCS, [compiler, *_FLAGS],
            _host_target(compiler))


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            so, _ = build_shared(*build_args())
            lib = ctypes.CDLL(str(so))
            lib.uhdr_join_blocks.restype = ctypes.c_int64
            lib.uhdr_join_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_encode_scan.restype = ctypes.c_int64
            lib.uhdr_encode_scan.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_decode_scan.restype = ctypes.c_int64
            lib.uhdr_decode_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.uhdr_decode_progressive_scan.restype = ctypes.c_int64
            lib.uhdr_decode_progressive_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.uhdr_idct_plane.restype = None
            lib.uhdr_idct_plane.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_ycbcr_to_rgb_planar.restype = None
            lib.uhdr_ycbcr_to_rgb_planar.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.uhdr_ycbcr_to_rgb888.restype = None
            lib.uhdr_ycbcr_to_rgb888.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            lib.uhdr_ycc_to_rgba32.restype = None
            lib.uhdr_ycc_to_rgba32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_void_p]
            lib.uhdr_pack_p010_10bit.restype = None
            lib.uhdr_pack_p010_10bit.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.uhdr_pack_delta.restype = ctypes.c_int64
            lib.uhdr_pack_delta.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_pack_delta_g.restype = ctypes.c_int64
            lib.uhdr_pack_delta_g.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_pack_vw.restype = ctypes.c_int64
            lib.uhdr_pack_vw.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_pack_slices.restype = ctypes.c_int64
            lib.uhdr_pack_slices.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64]
            lib.uhdr_unpack_delta2d.restype = ctypes.c_int64
            lib.uhdr_unpack_delta2d.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int32, ctypes.c_void_p]
            lib.uhdr_extract_channel10.restype = None
            lib.uhdr_extract_channel10.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p]
            lib.uhdr_apply_gainmap_host.restype = ctypes.c_int
            lib.uhdr_apply_gainmap_host.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
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


def encode_scan(comps, mcus_w: int, mcus_h: int, dc_tables, ac_tables,
                restart_interval: int = 0) -> bytes:
    """Encode one interleaved baseline scan on the host.  comps: [{coeffs:
    (bh, bw, 64) int16 zigzag coefficients, MCU-padded, h, v, dc_tbl,
    ac_tbl}, ...].  Returns the entropy-coded bytes, stuffed."""
    lib = get_lib()
    n = len(comps)
    arrs = [np.ascontiguousarray(c["coeffs"], np.int16) for c in comps]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    meta = np.zeros((n, 6), np.int32)
    for i, c in enumerate(comps):
        bh, bw = arrs[i].shape[:2]
        meta[i] = [bw, bh, c["h"], c["v"], c["dc_tbl"], c["ac_tbl"]]
    dcb, dcv, acb, acv = _table_blobs(dc_tables, ac_tables)
    # room for every coefficient a longest code, stuffed: 4 bytes each
    cap = sum(a.size for a in arrs) * 4 + 65536
    out = np.empty(cap, np.uint8)
    written = lib.uhdr_encode_scan(
        ptrs, meta.ctypes.data, n, mcus_w, mcus_h, restart_interval,
        dcb.ctypes.data, dcv.ctypes.data, acb.ctypes.data, acv.ctypes.data,
        out.ctypes.data, cap)
    if written < 0:
        raise RuntimeError(f"entropy encode failed: {written}")
    return out[:written].tobytes()


def _require_table(tables, idx: int, kind: str):
    """libjpeg parity: a scan referencing an absent or out-of-range table
    is rejected (jdhuff.c jpeg_make_d_derived_tbl, JERR_NO_HUFF_TABLE)."""
    if not (0 <= idx <= 3) or tables[idx] is None:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        f"scan references missing {kind} huffman table "
                        f"{idx}")


def decode_scan(data: bytes, comps, mcus_w: int, mcus_h: int, dc_tables,
                ac_tables, restart_interval: int = 0):
    """Decode one interleaved baseline scan (`data` starts right after the
    SOS header).  comps: [{h, v, dc_tbl, ac_tbl}, ...].  Returns
    ([(bh, bw, 64) int16 zigzag coefficients per component, MCU-padded],
    bytes consumed)."""
    lib = get_lib()
    for c in comps:
        _require_table(dc_tables, c["dc_tbl"], "DC")
        _require_table(ac_tables, c["ac_tbl"], "AC")
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


def decode_progressive_scan(data: bytes, coeff_arrays, comps, scan_comps,
                            ss: int, se: int, ah: int, al: int,
                            mcus_w: int, mcus_h: int, restart_interval: int,
                            dc_tables, ac_tables):
    """Decode one progressive SOS (T.81 G.2) into `coeff_arrays` in place.

    coeff_arrays: the image's (bh, bw, 64) int16 zigzag arrays, MCU-padded
    and C-contiguous (their pointers are handed to the C++); comps: per
    image component {h, v}; scan_comps: [(comp_index, dc_tbl, ac_tbl, sbw,
    sbh), ...], sbw/sbh the component's non-interleaved block counts."""
    lib = get_lib()
    # only the tables the scan uses must exist (jdphuff.c start_pass:
    # DC-first needs DC tables, AC scans the AC table, DC refine none)
    for sc in scan_comps:
        if ss == 0 and ah == 0:
            _require_table(dc_tables, sc[1], "DC")
        elif ss > 0:
            _require_table(ac_tables, sc[2], "AC")
    for a in coeff_arrays:
        if a.dtype != np.int16 or not a.flags.c_contiguous:
            raise ValueError("coefficient arrays must be C-contiguous int16")
    n = len(coeff_arrays)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in coeff_arrays])
    meta = np.zeros((n, 6), np.int32)
    for i, c in enumerate(comps):
        bh, bw = coeff_arrays[i].shape[:2]
        meta[i] = [bw, bh, c["h"], c["v"], 0, 0]
    smeta = np.asarray(scan_comps, np.int32).reshape(-1, 5)
    dcb, dcv, acb, acv = _table_blobs(dc_tables, ac_tables)
    buf = np.frombuffer(data, np.uint8)
    rc = lib.uhdr_decode_progressive_scan(
        buf.ctypes.data, len(data), ptrs, meta.ctypes.data, n,
        smeta.ctypes.data, smeta.shape[0], ss, se, ah, al,
        mcus_w, mcus_h, restart_interval,
        dcb.ctypes.data, dcv.ctypes.data, acb.ctypes.data, acv.ctypes.data)
    if rc < 0:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        f"progressive scan decode failed: {rc}")


def idct_plane(coeffs: np.ndarray, qt_natural: np.ndarray) -> np.ndarray:
    """Host IDCT: (bh, bw, 64) int16 zigzag coefficients + natural-order
    quant table -> (bh*8, bw*8) uint8 plane (AAN float, host_decode.cpp)."""
    lib = get_lib()
    c = np.ascontiguousarray(coeffs, np.int16)
    q = np.ascontiguousarray(qt_natural, np.int32).reshape(64)
    bh, bw = c.shape[:2]
    out = np.empty((bh * 8, bw * 8), np.uint8)
    lib.uhdr_idct_plane(c.ctypes.data, bh, bw, q.ctypes.data,
                        out.ctypes.data, bw * 8)
    return out


def ycbcr_to_rgb_planar(y: np.ndarray, cb: np.ndarray,
                        cr: np.ndarray) -> np.ndarray:
    """Full-range Rec.601 (h, w) u8 YCbCr planes -> (3, h, w) u8 planar
    RGB (the host engine keeps a 3-channel gain map planar, so the apply
    gathers straight from u8 rows)."""
    lib = get_lib()
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape
    out = np.empty((3, h, w), np.uint8)
    lib.uhdr_ycbcr_to_rgb_planar(
        y.ctypes.data, w, cb.ctypes.data, cr.ctypes.data, w, w, h,
        out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data)
    return out


_SAMPLING_CODE = {"444": 0, "420": 1, "422": 2, "440": 3, "411": 4,
                  "410": 5}


def ycc_to_rgba32(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  fmt_key: str, h: int, w: int) -> np.ndarray:
    """libjpeg's fancy chroma upsample and jdcolor fixed-point conversion
    in one pass -> packed RGBA8888 (h, w) uint32, alpha 255 (host C++,
    host_decode.cpp uhdr_ycc_to_rgba32; the bytes of
    ``decoder.planes_to_rgb``)."""
    lib = get_lib()
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    ch_, cw_ = cb.shape
    out = np.empty((h, w), np.uint32)
    lib.uhdr_ycc_to_rgba32(
        y.ctypes.data, y.shape[1], cb.ctypes.data, cr.ctypes.data, cw_,
        cw_, ch_, w, h, _SAMPLING_CODE[fmt_key], out.ctypes.data)
    return out


def ycbcr_to_rgb888(y: np.ndarray, cb: np.ndarray,
                    cr: np.ndarray) -> np.ndarray:
    """Full-range Rec.601 (h, w) u8 YCbCr planes -> (h, w, 3) u8 RGB
    (host C++)."""
    lib = get_lib()
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.uhdr_ycbcr_to_rgb888(y.ctypes.data, w, cb.ctypes.data,
                             cr.ctypes.data, w, w, h, out.ctypes.data)
    return out


def apply_gainmap_host(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       hf: int, vf: int, w: int, h: int,
                       gm: np.ndarray, k: int, meta15: np.ndarray,
                       weight: float, out_ct: int,
                       gamut_m: np.ndarray | None,
                       gamut_pre: bool,
                       gm_planar: bool = False) -> np.ndarray:
    """The host engine's fused apply (``uhdr_apply_gainmap_host``).

    gm: (mh, mw) u8 single-channel, (mh, mw, 3) u8 interleaved, or
    (3, mh, mw) u8 planar (`gm_planar`).  Returns (h, w) uint32 packed
    RGBA1010102 (out_ct 1 HLG, 2 PQ) or (h, w) uint64 packed RGBAF16
    (out_ct 0)."""
    lib = get_lib()
    yc, uc, vc, gmc = (np.ascontiguousarray(p, np.uint8)
                       for p in (y, u, v, gm))
    ch = 3 if gmc.ndim == 3 else 1
    if gm_planar and (gmc.ndim != 3 or gmc.shape[0] != 3):
        raise ValueError(f"a planar gain map is (3, mh, mw), not "
                         f"{gmc.shape}")
    mh, mw = gmc.shape[1:3] if gm_planar else gmc.shape[:2]
    m = np.ascontiguousarray(meta15, np.float32).reshape(15)
    gp = None if gamut_m is None else \
        np.ascontiguousarray(gamut_m, np.float32).reshape(9)
    out = np.empty((h, w), np.uint64 if out_ct == 0 else np.uint32)
    rc = lib.uhdr_apply_gainmap_host(
        yc.ctypes.data, yc.shape[1], uc.ctypes.data, vc.ctypes.data,
        uc.shape[1], hf, vf, w, h, gmc.ctypes.data, ch, mw, mh, k,
        int(bool(gm_planar)), m.ctypes.data, float(weight), int(out_ct),
        gp.ctypes.data if gp is not None else None, int(bool(gamut_pre)),
        out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"apply_gainmap_host failed: {rc}")
    return out


# ---------------------------------------------------------------------------
# the wire codecs' host halves (wire.py)

def pack_p010_10bit(arr: np.ndarray) -> np.ndarray:
    """Pack the 10 MSB-resident bits of a uint16 array into a dense 10-bit
    little-endian stream: (n,) u16 -> (ceil(n/16)*10,) u16."""
    lib = get_lib()
    flat = np.ascontiguousarray(arr, np.uint16).reshape(-1)
    pad = (-flat.size) % 16
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint16)])
    out = np.empty((flat.size // 16) * 10, np.uint16)
    lib.uhdr_pack_p010_10bit(flat.ctypes.data, flat.size, out.ctypes.data)
    return out


DELTA7_ESC_CAP = 65536


def pack_delta_into(plane: np.ndarray, uv_interleaved: bool,
                    words: np.ndarray, esc_idx: np.ndarray,
                    esc_val: np.ndarray, *, two_d: bool = False,
                    bits: int = 7) -> bool:
    """Delta + bit-sliced packing of a P010 plane (``uhdr_pack_delta``)
    into caller-provided buffers (views into one wire buffer); the escape
    capacity is esc_idx's length, padded entries index 1 << 30.  `two_d`
    removes the vertical delta first.  False when the escapes overflow."""
    lib = get_lib()
    p = np.ascontiguousarray(plane, np.uint16)
    rows, cols = p.shape
    esc_idx[:] = np.int32(1 << 30)
    esc_val[:] = 0
    n_esc = lib.uhdr_pack_delta(p.ctypes.data, rows, cols,
                                int(bool(uv_interleaved)), int(bool(two_d)),
                                int(bits), words.ctypes.data,
                                esc_idx.ctypes.data, esc_val.ctypes.data,
                                esc_idx.size)
    return n_esc >= 0


def pack_delta7_into(plane: np.ndarray, uv_interleaved: bool,
                     words: np.ndarray, esc_idx: np.ndarray,
                     esc_val: np.ndarray) -> bool:
    """pack_delta_into at the 1D/7-bit default (the original delta7)."""
    return pack_delta_into(plane, uv_interleaved, words, esc_idx, esc_val)


def pack_delta_g_into(plane_u16: np.ndarray, words: np.ndarray,
                      esc_idx: np.ndarray, esc_val32: np.ndarray, *,
                      two_d: bool = True, bits: int = 5, shift: int = 0,
                      base: int = 512) -> bool:
    """The general delta pack (``uhdr_pack_delta_g``): raw u16 samples
    (shift 0) or MSB-aligned 10-bit ones (shift 6), int32 escape values.
    False on escape overflow."""
    lib = get_lib()
    p = np.ascontiguousarray(plane_u16, np.uint16)
    rows, cols = p.shape
    esc_idx[:] = np.int32(1 << 30)
    esc_val32[:] = 0
    n = lib.uhdr_pack_delta_g(p.ctypes.data, rows, cols, 0,
                              int(bool(two_d)), int(bits), int(shift),
                              int(base), words.ctypes.data,
                              esc_idx.ctypes.data, esc_val32.ctypes.data,
                              esc_idx.size)
    return n >= 0


def pack_vw_into(plane: np.ndarray, uv_interleaved: bool,
                 width_words: np.ndarray, payload: np.ndarray, *,
                 shift: int = 6, base: int = 512) -> int | None:
    """The variable-width group pack (``uhdr_pack_vw``): 2D residuals,
    each 32-sample group bit-sliced at its own width 0..12 (4 bits a group
    in width_words).  Returns the payload's live word count, or None when
    the payload is too small or a group needs more than 12 bits."""
    lib = get_lib()
    p = np.ascontiguousarray(plane, np.uint16)
    rows, cols = p.shape
    n = lib.uhdr_pack_vw(p.ctypes.data, rows, cols,
                         int(bool(uv_interleaved)), int(shift), int(base),
                         width_words.ctypes.data, payload.ctypes.data,
                         payload.size)
    return int(n) if n >= 0 else None


def pack_slices_into(flat_i16: np.ndarray, bits: int, words: np.ndarray,
                     esc_idx: np.ndarray, esc_val: np.ndarray) -> bool:
    """Bit-slice a flat int16 stream at `bits` a sample with escapes
    (``uhdr_pack_slices``, the coefficient wire's rungs) into caller-owned
    views; escape capacity esc_idx.size.  False on escape overflow."""
    lib = get_lib()
    a = np.ascontiguousarray(flat_i16, np.int16)
    esc_idx[:] = np.int32(1 << 30)
    esc_val[:] = 0
    n = lib.uhdr_pack_slices(a.ctypes.data, a.size, int(bits),
                             words.ctypes.data, esc_idx.ctypes.data,
                             esc_val.ctypes.data, esc_idx.size)
    return n >= 0


def pack_delta7(plane: np.ndarray, uv_interleaved: bool, *,
                two_d: bool = False, bits: int = 7):
    """pack_delta_into with buffers of its own: (words (n32, bits) u32,
    esc_idx (CAP,) i32, esc_val (CAP,) i16), or None on overflow."""
    rows, cols = plane.shape
    words = np.empty((-(-(rows * cols) // 32), bits), np.uint32)
    esc_idx = np.empty(DELTA7_ESC_CAP, np.int32)
    esc_val = np.empty(DELTA7_ESC_CAP, np.int16)
    if not pack_delta_into(plane, uv_interleaved, words, esc_idx, esc_val,
                           two_d=two_d, bits=bits):
        return None
    return words, esc_idx, esc_val


def extract_channel10(plane_u32: np.ndarray, shift: int) -> np.ndarray:
    """((plane >> shift) & 1023) as u16 (an RGBA1010102 channel for the RGB
    upload wire)."""
    lib = get_lib()
    p = np.ascontiguousarray(plane_u32, np.uint32)
    out = np.empty(p.shape, np.uint16)
    lib.uhdr_extract_channel10(p.ctypes.data, p.size, shift,
                               out.ctypes.data)
    return out


def unpack_delta2d(words: np.ndarray, esc_idx: np.ndarray,
                   esc_val: np.ndarray, n_esc: int, rows: int, cols: int,
                   bits: int, base: int) -> np.ndarray:
    """The download wire's host half: one channel's bit-sliced 2D-delta
    codes -> (rows, cols) u16 samples.  Escape indices ascend."""
    lib = get_lib()
    w = np.ascontiguousarray(words, np.uint32)
    ei = np.ascontiguousarray(esc_idx, np.int32)
    ev = np.ascontiguousarray(esc_val, np.int32)
    out = np.empty((rows, cols), np.uint16)
    r = lib.uhdr_unpack_delta2d(w.ctypes.data, ei.ctypes.data,
                                ev.ctypes.data, int(n_esc), rows, cols,
                                int(bits), int(base), out.ctypes.data)
    if r < 0:
        raise ValueError(f"unpack_delta2d failed: {r}")
    return out
