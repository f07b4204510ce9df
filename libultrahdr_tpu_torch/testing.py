"""Test content and output checks for the port, numpy and host only.

- ``photo_p010``: the numpy twin of ``benchmarks.photo_p010`` (which imports
  the JAX package), tiles of the committed photograph
  ``tests/data/photo_yu12_320x240.npz`` with per-tile exposure and a smooth
  HDR highlight field;
- ``read_jpegr``: split a JPEG_R file through its MPF index and read the
  gain map's ISO 21496-1 metadata;
- ``decode_scan_coeffs``: decode one JPEG's scan back to its quantised
  coefficients with the shared native decoder;
- ``check_decoded_close``: the contract between two decodes of one file
  (RGBA1010102 or RGBAF16 output) by different programs or devices.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from ._buildlib import PKG_DIR
from .container import iso21496, mpf
from .container.jpegr_container import ISO_NS
from .jpeg import native
from .jpeg.device_entropy import ScanLayout
from .jpeg.tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA
from .types import (ColorGamut, ColorRange, ColorTransfer, GainMapMetadata,
                    ImgFmt, RawImage)

PHOTO_NPZ = PKG_DIR.parent / "tests" / "data" / "photo_yu12_320x240.npz"


def photo_p010(w: int, h: int, seed: int = 11) -> RawImage:
    """Photographic P010 BT2100/HLG content at (w, h), plane for plane the
    JAX package's ``benchmarks.photo_p010(w, h, seed)``."""
    z = np.load(PHOTO_NPZ)
    y8, u8, v8 = z["y"], z["u"], z["v"]
    rs = np.random.RandomState(seed)
    fh, fw = y8.shape
    ty, tx = -(-h // fh), -(-w // fw)
    gains = 0.7 + 0.6 * rs.rand(ty, tx).astype(np.float32)

    def tile(p, th, tw):
        rows = []
        for iy in range(ty):
            cells = []
            for ix in range(tx):
                t = p.astype(np.float32) * gains[iy, ix]
                if ix % 2:
                    t = t[:, ::-1]
                if iy % 2:
                    t = t[::-1, :]
                cells.append(t)
            rows.append(np.concatenate(cells, axis=1))
        return np.concatenate(rows, axis=0)[:th, :tw]

    lum = tile(y8, h, w) / 255.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hl = 0.25 * np.exp(-(((yy / h - 0.3) ** 2 + (xx / w - 0.7) ** 2)
                         / 0.08))
    y10 = np.clip((0.1 + 0.65 * lum + hl) * 1023, 0, 1023)
    y10 = y10.astype(np.uint16) << 6
    cu = tile(u8, h // 2, w // 2)
    cv = tile(v8, h // 2, w // 2)
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = np.clip(cu * 4.0, 0, 1023).astype(np.uint16) << 6
    uv[:, 1::2] = np.clip(cv * 4.0, 0, 1023).astype(np.uint16) << 6
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h,
                    [np.ascontiguousarray(y10), np.ascontiguousarray(uv)])


def coefficient_planes(layout: ScanLayout, seed: int) -> list[np.ndarray]:
    """Seeded (bh, bw, 64) int16 zigzag coefficient planes for `layout`
    that hold the pack's edge cases: all-zero blocks, coefficient 63
    nonzero (no EOB), runs of 16, 32 and 48 zeros (ZRLs) and a run of 16
    with nothing after it (no ZRL), |AC| up to 1023 and DC diffs of +-2047,
    among blocks of sparse, medium and dense random content."""
    rs = np.random.RandomState(seed)
    out = []
    for hs, vs in layout.sampling:
        bh, bw = layout.mcus_h * vs, layout.mcus_w * hs
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-1024, 1024, (bh, bw))
        density = rs.choice([0.0, 0.05, 0.3, 0.9], size=(bh, bw, 1))
        big = rs.rand(bh, bw, 63) < 0.05
        vals = np.where(big, rs.randint(-1023, 1024, (bh, bw, 63)),
                        rs.randint(-20, 21, (bh, bw, 63)))
        c[..., 1:] = np.where(rs.rand(bh, bw, 63) < density, vals, 0)
        flat = c.reshape(-1, 64)
        edges = [{},                                   # all zero
                 {63: 7},                              # 62 zeros, no EOB
                 {17: -3, 50: 1},                      # runs of 16 and 32
                 {49: 1023, 63: -1023},                # run of 48, no EOB
                 {k: (1023 if k % 2 else -1) for k in range(1, 64)},
                 {1: 5}]                               # run of 62 to EOB
        for i, e in enumerate(edges[:flat.shape[0]]):
            flat[i] = 0
            for k, v in e.items():
                flat[i, k] = v
        if flat.shape[0] > 7:                          # |DC diff| 2047
            flat[6, 0], flat[7, 0] = -1024, 1023
        out.append(c)
    return out


def _segments(jpeg: bytes):
    """(marker, payload start, payload end) of each header segment up to
    and including SOS."""
    if jpeg[:2] != b"\xFF\xD8":
        raise ValueError("not a JPEG: no SOI")
    pos = 2
    while pos + 4 <= len(jpeg):
        if jpeg[pos] != 0xFF:
            raise ValueError(f"bad marker at {pos}")
        marker = jpeg[pos + 1]
        end = pos + 2 + struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        yield marker, pos + 4, end
        if marker == 0xDA:
            return
        pos = end
    raise ValueError("no SOS segment")


def read_jpegr(data: bytes) -> tuple[bytes, bytes, GainMapMetadata]:
    """(primary JPEG, gain-map JPEG, ISO gain-map metadata) of a JPEG_R
    file.  Raises ValueError unless the MPF index names exactly the two
    JPEGs that make up the file and the gain map carries ISO metadata."""
    for marker, start, end in _segments(data):
        if marker == 0xE2 and data[start:start + 4] == mpf.MPF_SIG:
            entries = start + 4 + 50      # MP entries, after the index IFD
            p_size, = struct.unpack(">I", data[entries + 4:entries + 8])
            s_size, s_off = struct.unpack(">II",
                                          data[entries + 20:entries + 28])
            s_start = start + 4 + s_off   # offsets count from the TIFF header
            break
    else:
        raise ValueError("no MPF segment in the primary image")
    primary, gainmap = data[:p_size], data[s_start:s_start + s_size]
    if (s_start != p_size or s_start + s_size != len(data)
            or not all(j[:2] == b"\xFF\xD8" and j[-2:] == b"\xFF\xD9"
                       for j in (primary, gainmap))):
        raise ValueError("MPF entries do not split the file into two JPEGs")
    for marker, start, end in _segments(gainmap):
        if marker == 0xE2 and gainmap[start:end].startswith(ISO_NS):
            frac = iso21496.decode_gainmap_metadata(
                gainmap[start + len(ISO_NS):end])
            return primary, gainmap, iso21496.fraction_to_float(frac)
    raise ValueError("no ISO 21496-1 metadata in the gain-map image")


def scan_data(jpeg: bytes) -> bytes:
    """The entropy-coded segment of a single-scan JPEG: the bytes after the
    SOS header, up to and without the closing EOI."""
    sos_end = [end for marker, _, end in _segments(jpeg) if marker == 0xDA]
    if jpeg[-2:] != b"\xFF\xD9":
        raise ValueError("no EOI at the end of the JPEG")
    return jpeg[sos_end[0]:-2]


def decode_scan_coeffs(jpeg: bytes, layout: ScanLayout) -> list[np.ndarray]:
    """Quantised zigzag coefficients of a JPEG written by the port (one
    restart interval per MCU row, luma tables for component 0), decoded by
    the shared native decoder; one (bh, bw, 64) int16 array per
    component."""
    comps = [{"h": hs, "v": vs, "dc_tbl": int(i > 0), "ac_tbl": int(i > 0)}
             for i, (hs, vs) in enumerate(layout.sampling)]
    coeffs, _ = native.decode_scan(
        scan_data(jpeg), comps, layout.mcus_w, layout.mcus_h,
        [DC_LUMA, DC_CHROMA, None, None], [AC_LUMA, AC_CHROMA, None, None],
        restart_interval=layout.mcus_w)
    return coeffs


def host_packed(packed) -> np.ndarray:
    """A packed decode output as host numpy with its unsigned type:
    RGBA1010102 (H, W) np.uint32, RGBAF16 (H, W, 4) np.uint16.  Takes the
    device carriers (int32 / int16 tensors) or numpy arrays."""
    a = packed.cpu().numpy() if hasattr(packed, "cpu") else np.asarray(packed)
    if a.dtype in (np.int32, np.uint32):
        return a.view(np.uint32)
    if a.dtype in (np.int16, np.uint16) and a.ndim == 3 and a.shape[-1] == 4:
        return a.view(np.uint16)
    raise ValueError(f"not a packed decode output: {a.dtype} {a.shape}")


def codes_1010102(packed) -> np.ndarray:
    """(4, H, W) int64 codes of an RGBA1010102 output: R, G, B (10 bits)
    and A (2 bits)."""
    p = host_packed(packed).astype(np.int64)
    return np.stack([(p >> 0) & 1023, (p >> 10) & 1023, (p >> 20) & 1023,
                     (p >> 30) & 3])


def _values(packed) -> tuple[np.ndarray, float]:
    """(float64 samples, peak) of a packed output: 10-bit codes with peak
    1023, or half floats with the linear peak 10000/203."""
    p = host_packed(packed)
    if p.dtype == np.uint32:
        return codes_1010102(p)[:3].astype(np.float64), 1023.0
    return p[..., :3].view(np.float16).astype(np.float64), 10000.0 / 203.0


def psnr(got, want) -> float:
    """PSNR in dB of one packed output against another over R, G, B."""
    a, peak = _values(got)
    b, _ = _values(want)
    mse = np.mean((a - b) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(peak ** 2 / mse))


# RGBAF16 samples may differ by one step of the 1024-entry gain grid, where
# an ulp of the upstream float math moves a gain across a grid midpoint: a
# step is a factor max_boost**(1/1023), 1.0016 at the encoders' 1000/203,
# i.e. 1.6 to 3.2 half-float ulps.
F16_MAX_ULPS = 4
# Share of samples (R, G, B, A) that may differ at all.  An ulp moves a
# 10-bit code more often on the steep PQ curve: the port's CPU decode
# against the JAX package's differs on 1.4e-3 of the samples there, against
# about half of them for a rounding fault such as floor for rint.
SHARE_OFF = {np.dtype(np.uint32): 5e-3, np.dtype(np.uint16): 1e-3}


@functools.lru_cache(maxsize=2)
def attainable_codes(out_ct: ColorTransfer) -> np.ndarray:
    """Sorted 10-bit codes that an HLG or PQ output can take: the OETF at
    each point of its 65536-entry LUT grid (ops/lut_parity.py), rounded
    (float64 here).  Away from black consecutive grid points give codes
    equal or 1 apart; near black one step spans several codes (up to 7 for
    HLG and 76 for PQ)."""
    e = np.arange(65536, dtype=np.float64) / 65535.0
    if ColorTransfer(out_ct) == ColorTransfer.HLG:
        a, b, c = 0.17883277, 0.28466892, 0.55991073
        v = np.where(e <= 1.0 / 12.0, np.sqrt(3.0 * e),
                     a * np.log(np.maximum(12.0 * e - b, 1e-37)) + c)
    else:
        m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
        c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 4096.0 * 32.0, \
            2392.0 / 4096.0 * 32.0
        ep = e ** m1
        v = np.where(e <= 0.0, 0.0, ((c1 + c2 * ep) / (1.0 + c3 * ep)) ** m2)
    return np.unique(np.round(np.clip(v, 0.0, 1.0) * 1023.0).astype(np.int64))


def check_decoded_close(got, want, out_ct: ColorTransfer,
                        what: str = "") -> tuple[int, float]:
    """Hold a packed decode output against another of the same file, made
    by another program or on another device.  Transcendentals may differ by
    an ulp between the two, and a LUT grid (ops/lut_parity.py) now and then
    turns that into one step of the grid, so:

    - RGBA1010102 (HLG/PQ): every code equals the other or is its neighbour
      among ``attainable_codes(out_ct)`` (no attainable code lies between
      the two): within 1 away from black, one step of the 65536-entry OETF
      grid near it;
    - RGBAF16 (LINEAR): the half-float patterns are within F16_MAX_ULPS;
    - both: at most SHARE_OFF of the samples differ (5e-3 for RGBA1010102,
      1e-3 for RGBAF16), and PSNR >= 60 dB.

    A kernel held against its plain version on the same device is held to
    equality instead (chip_smoke.py).

    Returns (max abs difference, share of differing samples); raises
    AssertionError outside the contract."""
    a, b = host_packed(got), host_packed(want)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: output {a.dtype} {a.shape} vs "
                             f"{b.dtype} {b.shape}")
    if a.dtype == np.uint32:
        ca, cb = codes_1010102(a), codes_1010102(b)
        diff = np.abs(ca - cb)
        lo, hi = np.minimum(ca[:3], cb[:3]), np.maximum(ca[:3], cb[:3])
        table = attainable_codes(out_ct)
        between = (np.searchsorted(table, hi, "left")
                   - np.searchsorted(table, lo, "right"))
        ok = bool((between <= 0).all() and (ca[3] == cb[3]).all())
        limit = "neighbouring attainable codes"
    else:
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        ok = int(diff.max()) <= F16_MAX_ULPS
        limit = f"{F16_MAX_ULPS} ulps"
    err, share = int(diff.max()), float((diff > 0).mean())
    share_limit = SHARE_OFF[a.dtype]
    db = psnr(a, b)
    if not ok or share > share_limit or db < 60.0:
        raise AssertionError(f"{what}: max abs difference {err} (limit "
                             f"{limit}), {share:.2e} of samples differ "
                             f"(limit {share_limit}), PSNR {db:.2f} dB")
    return err, share
