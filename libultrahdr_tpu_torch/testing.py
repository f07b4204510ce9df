"""Test content and output checks for the port.

- ``photo_p010``: the numpy twin of ``benchmarks.photo_p010`` (which imports
  the JAX package), tiles of the committed photograph
  ``tests/data/photo_yu12_320x240.npz`` with per-tile exposure and a smooth
  HDR highlight field; ``photo_rgba1010102`` and ``photo_rgbaf16``, the twins
  of ``benchmarks._p010_to_rgba1010102`` / ``_p010_to_rgbaf16`` applied to
  it, and ``photo_yuv444_10``, the same samples as three 10-bit planes;
- ``read_jpegr``: split a JPEG_R file through its MPF index and read the
  gain map's ISO 21496-1 metadata;
- ``decode_scan_coeffs``: decode one JPEG's scan back to its quantised
  coefficients with the host native decoder; ``scan_coeffs``: the
  coefficient planes a scan of the fused encodes is built into;
- ``pack_scans_v1`` / ``pack_scans_v2``: the block-pack and tile-pack
  routes (slots -> kernel -> compaction), which no request runs;
- ``apply_tables_plain`` / ``apply_gainmap_tables``: the apply kernel's
  tables from the plain ops on their LUT grids, and its table formulation
  of the whole apply, for holding the kernel's design against
  ``apply_gainmap_plain``; ``apply_edge_inputs`` and
  ``pack_worst_case_stream``, the two kernels' edge-case inputs, and
  ``synthetic_slots``, slot inputs of the block pack and the tile pack at
  any block count; ``unslice_edge_cases`` and ``down_pack_edge_cases``,
  the wire kernels' edge cases at the seams of their CTA runs and tiles,
  placed on the card at their alignment by ``aligned_tensor``;
- ``dri_less_jpeg``, ``stuffed_jpeg``, ``huffman_edge_cases`` and
  ``huffman_fault_cases``: baseline JPEGs without restart markers for the
  card's entropy decoder (``jpeg/huffman_kernel``), with the subsequence
  size each is decoded at, and streams it must refuse;
- ``join_words`` and ``join_edge_cases``: the restart-row join's inputs
  (``jpeg/join_kernel``), words laid out as the pack lays them, and
  ``host_join``, its reference;
- ``launch_ms``, ``pack_kernel_ms``, ``slot_pack_kernel_ms``: a kernel's
  time on the card without its wrapper's host work;
- ``check_decoded_close``: the contract between two decodes of one file
  (RGBA1010102 or RGBAF16 output) by different programs or devices;
- ``progressive_jpegr`` / ``write_progressive_fixture``: a JPEG_R file
  with its base re-encoded progressive (PIL), and the committed 4K fixture
  ``tests/data/progressive_jpegr_3840x2160.jpg`` made from the benchmark
  configuration's file;
- the reference goldens ``tests/goldens/*.npz`` (written once by the
  reference library, ``tools/make_reference_goldens.py``): ``golden_names``,
  ``load_golden``, ``golden_input`` (the raw input as a port RawImage),
  ``golden_encoder`` (a ``UhdrEncoder`` at a golden's configuration),
  ``golden_metadata`` (its metadata kind), ``golden_effects`` /
  ``queue_effects`` (the effects golden's queues), ``psnr_8888`` (the
  SRGB output's PSNR; ``psnr`` gives the HDR outputs', as the reference
  tests compute them) and the reference tests' gates.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import pathlib
import struct

import numpy as np
import torch

from ._buildlib import PKG_DIR
from .container import iso21496, mpf
from .container.jpegr_container import ISO_NS
from .jpeg import dct, native, pack_kernel
from .jpeg.device_entropy import ScanLayout, _default_budget
from .jpeg.tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA
from .ops import apply_kernel, colors, pixel
from .ops.lut_parity import (GAIN_FACTOR_N, HLG_OETF_N, PQ_OETF_N,
                             SRGB_INV_OETF_N, lut_quantize)
from .types import (ColorGamut, ColorRange, ColorTransfer, GainMapMetadata,
                    ImgFmt, RawImage)

PHOTO_NPZ = PKG_DIR.parent / "tests" / "data" / "photo_yu12_320x240.npz"
PROGRESSIVE_FIXTURE = PKG_DIR.parent / "tests" / "data" / \
    "progressive_jpegr_3840x2160.jpg"
GOLDENS_DIR = PKG_DIR.parent / "tests" / "goldens"
EFFECTS_GOLDEN = "effects_p010_iso_single_s4"


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


def _photo_samples(w: int, h: int, seed: int):
    """(y, u, v) 10-bit samples of photo_p010 at full resolution, chroma
    replicated; an odd size crops the next even size's image."""
    img = photo_p010(w + w % 2, h + h % 2, seed)
    uv = img.planes[1] >> 6

    def full(c):
        return np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)[:h, :w]
    return (img.planes[0][:h, :w] >> 6), full(uv[:, 0::2]), full(uv[:, 1::2])


def photo_rgba1010102(w: int, h: int, seed: int = 11) -> RawImage:
    """photo_p010's samples repacked as BT2100 HLG RGBA1010102 (R = Y,
    G = Cb, B = Cr; the same pixel entropy, not a colour conversion), plane
    for plane ``benchmarks._p010_to_rgba1010102(photo_p010(w, h, seed))``."""
    y, u, v = (c.astype(np.uint32) for c in _photo_samples(w, h, seed))
    packed = y | (u << 10) | (v << 20) | np.uint32(0x3 << 30)
    return RawImage(ImgFmt.RGBA1010102, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h, [np.ascontiguousarray(packed)])


def photo_rgbaf16(w: int, h: int, seed: int = 11) -> RawImage:
    """photo_p010's samples / 1023 as BT2100 LINEAR RGBAF16 half-float bit
    patterns (u16), plane for plane
    ``benchmarks._p010_to_rgbaf16(photo_p010(w, h, seed))``."""
    comp = np.empty((h, w, 4), np.float16)
    for i, c in enumerate(_photo_samples(w, h, seed)):
        comp[..., i] = (c.astype(np.float32) / 1023.0).astype(np.float16)
    comp[..., 3] = np.float16(1.0)
    return RawImage(ImgFmt.RGBAF16, ColorGamut.BT2100, ColorTransfer.LINEAR,
                    ColorRange.FULL, w, h,
                    [np.ascontiguousarray(comp).view(np.uint16)])


def photo_yuv444_10(w: int, h: int, seed: int = 11) -> RawImage:
    """photo_p010's samples as BT2100 HLG YUV444_10: three u16 planes of
    10-bit samples, chroma replicated."""
    planes = [np.ascontiguousarray(c) for c in _photo_samples(w, h, seed)]
    return RawImage(ImgFmt.YUV444_10, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h, planes)


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


ICC_SIG = b"ICC_PROFILE\x00"


def without_app_segments(jpeg: bytes, keep_icc: bool = False) -> bytes:
    """A JPEG with its APPn segments (JFIF, EXIF, XMP, ICC, MPF, ISO)
    dropped, but for its ICC profile with `keep_icc`: the image itself,
    which a JPEG_R container passes through."""
    out, pos = bytearray(jpeg[:2]), 2
    for marker, start, end in _segments(jpeg):
        if not 0xE0 <= marker <= 0xEF or (
                keep_icc and marker == 0xE2
                and jpeg[start:start + len(ICC_SIG)] == ICC_SIG):
            out += jpeg[start - 4:end]
        pos = end
    return bytes(out + jpeg[pos:])


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
    the host native decoder; one (bh, bw, 64) int16 array per
    component."""
    comps = [{"h": hs, "v": vs, "dc_tbl": int(i > 0), "ac_tbl": int(i > 0)}
             for i, (hs, vs) in enumerate(layout.sampling)]
    coeffs, _ = native.decode_scan(
        scan_data(jpeg), comps, layout.mcus_w, layout.mcus_h,
        [DC_LUMA, DC_CHROMA, None, None], [AC_LUMA, AC_CHROMA, None, None],
        restart_interval=layout.mcus_w)
    return coeffs


def scan_coeffs(src, layout: ScanLayout) -> list[torch.Tensor]:
    """A scan's (bh, bw, 64) int16 coefficient planes on its device: for a
    ``dct.ScanPlanes`` the stream that ``dct.scan_inputs`` builds (on the
    card, the kernel), taken back out of MCU order; coefficient planes as
    they are."""
    if not isinstance(src, dct.ScanPlanes):
        return list(src)
    mh, mw = layout.mcus_h, layout.mcus_w
    stream = dct.scan_inputs([(src, layout)])[0].reshape(mh, mw, -1, 64)
    out, off = [], 0
    for hs, vs in layout.sampling:
        part = stream[:, :, off:off + hs * vs].reshape(mh, mw, vs, hs, 64)
        out.append(part.permute(0, 2, 1, 3, 4).reshape(mh * vs, mw * hs, 64))
        off += hs * vs
    return out


def scans_slots(scans):
    """Slots of several scans [(dct.ScanPlanes or coefficient planes,
    layout), ...] for the block pack and the tile pack, concatenated in
    order."""
    pays, lens = zip(*(pack_kernel.slots_for_kernel(scan_coeffs(c, lay), lay)
                       for c, lay in scans))
    return torch.cat(pays), torch.cat(lens)


def pack_scans_v1(scans):
    """The block-pack route for several scans in one launch: slots ->
    pack_blocks -> compact_blocks_t.  Returns (words (total,) int32, blen
    (n,) int32 with the row pads); split and join them per scan with
    fused.fetch_blocks_multi.  No request runs it: it drives the ported
    ``pack_blocks_pallas`` end to end for the tests and chip_smoke."""
    bb_t, blen = pack_kernel.pack_blocks(*scans_slots(scans))
    total = int(((blen.to(torch.int64) + 31) >> 5).sum())
    return pack_kernel.compact_blocks_t(bb_t, blen, total), blen


def pack_scans_v2(scans, budget: int | None = None):
    """The tile-pack route for several scans in one launch: slots ->
    pack_tiles -> tile_live_words -> stitch_tiles, budget words per block
    (default device_entropy._default_budget).  Returns (words, blen) as
    pack_scans_v1; raises PackOverflowError when a tile overflowed its
    budget.  No request runs it (see pack_scans_v1)."""
    pays, lens = scans_slots(scans)
    if budget is None:
        budget = _default_budget(pays.shape[0])
    tiles, blen = pack_kernel.pack_tiles(pays, lens, budget)
    pack_kernel.check_tile_budgets(blen.cpu().numpy(), budget)
    return pack_kernel.stitch_tiles(
        [(tiles, pack_kernel.tile_live_words(blen))]), blen


def _grid(n: int, dev) -> torch.Tensor:
    """The n points of a LUT grid, as lut_quantize gives them."""
    return lut_quantize(torch.arange(n, dtype=torch.float32, device=dev)
                        / (n - 1), n)


def _code10(x: torch.Tensor) -> torch.Tensor:
    """10-bit codes as pixel.pack_rgba1010102 rounds them, int32."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 1023.0).to(torch.int32)


def apply_tables_plain(dev) -> dict[str, torch.Tensor]:
    """The apply kernel's request-independent tables (its
    APPLY_KERNEL.tables) from the plain ops on their LUT grids: "srgb" (1024,)
    float32, the sRGB inverse OETF; "hlg" and "pq" (65536,) int32, the
    10-bit code of each OETF."""
    q = _grid(HLG_OETF_N, dev)
    return {"srgb": colors.srgb_inv_oetf(_grid(SRGB_INV_OETF_N, dev)),
            "hlg": _code10(colors.hlg_oetf(q)),
            "pq": _code10(colors.pq_oetf(_grid(PQ_OETF_N, dev)))}


def _lookup(table: torch.Tensor, x: torch.Tensor, n: int, computed):
    """table at lut_quantize's index of x; computed(x) where x is NaN."""
    idx = torch.clamp(torch.floor(x * (n - 1) + 0.5), 0.0, float(n - 1))
    got = table[torch.nan_to_num(idx).to(torch.int64)]
    nan = torch.isnan(x)
    return torch.where(nan, computed(x), got) if bool(nan.any()) else got


def apply_gainmap_tables(sdr_yuv: torch.Tensor, gain: torch.Tensor,
                         meta_rows, weight: float, *, out_ct: ColorTransfer,
                         sdr_cg: ColorGamut, hdr_cg: ColorGamut,
                         use_base_cg: bool) -> torch.Tensor:
    """The apply kernel's table formulation (csrc/apply_kernel.cu) in plain
    PyTorch, op for op ``apply_gainmap_plain`` with each function of a LUT
    grid point gathered from a table made by the same plain ops on the
    grid: the sRGB inverse OETF, each channel's gain factor, and for HLG
    and PQ the 10-bit code of the OETF.  A NaN argument takes the computed
    value.  It must equal ``apply_gainmap_plain`` bit for bit."""
    out_ct = ColorTransfer(out_ct)
    dev = sdr_yuv.device
    tables = apply_tables_plain(dev)
    mat3 = apply_kernel._mat3
    rgb_sdr = [_lookup(tables["srgb"], torch.clamp(c, 0.0, 1.0),
                       SRGB_INV_OETF_N,
                       lambda x: colors.srgb_inv_oetf(
                           lut_quantize(x, SRGB_INV_OETF_N)))
               for c in mat3(colors.P3_YUV2RGB,
                             [sdr_yuv[0], sdr_yuv[1], sdr_yuv[2]])]
    gamut_m = colors.gamut_conversion_matrix(hdr_cg, sdr_cg)
    if not use_base_cg:
        rgb_sdr = mat3(gamut_m, rgb_sdr)

    meta = torch.from_numpy(np.asarray(meta_rows, np.float32)).to(dev)
    w_scalar = torch.tensor(np.float32(weight), device=dev)
    rgb_hdr = []
    for c in range(3):
        gamma, min_b, max_b, off_s, off_h = meta[:, c]

        def factor(g, min_b=min_b, max_b=max_b):
            return torch.exp2((torch.log2(min_b) * (1.0 - g)
                               + torch.log2(max_b) * g) * w_scalar)
        g = gain[c if gain.shape[0] == 3 else 0]
        g = torch.where(gamma != 1.0,
                        torch.pow(torch.clamp(g, min=0.0), 1.0 / gamma), g)
        f = _lookup(factor(_grid(GAIN_FACTOR_N, dev)),
                    torch.clamp(g, 0.0, 1.0), GAIN_FACTOR_N,
                    lambda x, factor=factor: factor(
                        lut_quantize(x, GAIN_FACTOR_N)))
        rgb_hdr.append((rgb_sdr[c] + off_s) * f - off_h)

    post_gamut = gamut_m if use_base_cg else np.eye(3, dtype=np.float32)
    if out_ct == ColorTransfer.LINEAR:
        return pixel.pack_rgbaf16(colors.clamp_pixel_float_linear(
            torch.stack(mat3(post_gamut, rgb_hdr))))
    hlg = out_ct == ColorTransfer.HLG
    scale = colors.SDR_WHITE_NITS / (colors.HLG_MAX_NITS if hlg
                                     else colors.PQ_MAX_NITS)
    rgb_hdr = [torch.clamp(c, 0.0, 1.0)
               for c in mat3(post_gamut, [c * scale for c in rgb_hdr])]
    if hlg:
        rgb_hdr = [torch.pow(torch.clamp(c, min=0.0), 1.0 / 1.2)
                   for c in rgb_hdr]
    oetf = colors.hlg_oetf if hlg else colors.pq_oetf
    q = [_lookup(tables[out_ct.name.lower()], c, HLG_OETF_N,
                 lambda x: _code10(oetf(lut_quantize(x, HLG_OETF_N))))
         for c in rgb_hdr]
    return q[0] | (q[1] << 10) | (q[2] << 20) | pixel._ALPHA_1010102


def apply_edge_inputs(h: int, w: int, chans: int, gamma: float = 1.0,
                      seed: int = 40):
    """(sdr (3, h, w) float32, gain (chans, h, w) float32, meta rows) numpy
    inputs of the apply with the cases a LUT index meets (h >= 7, w >= 10):
    grid ties (x * (N-1) at .5: in the sRGB grid through U = V = 0, where
    RGB = Y exactly, and in the gain grid), values outside [0, 1], exact
    grid points, and a NaN in each input."""
    rs = np.random.RandomState(seed + chans)
    sdr = np.stack([rs.uniform(-0.2, 1.2, (h, w)),
                    rs.uniform(-0.7, 0.7, (h, w)),
                    rs.uniform(-0.7, 0.7, (h, w))]).astype(np.float32)
    ties = ((rs.randint(0, 1023, w) + 0.5) / 1023).astype(np.float32)
    sdr[0, 0, :], sdr[1:, 0, :] = ties, 0.0
    sdr[0, 1, :8] = np.arange(8, dtype=np.float32) / 1023
    gain = (rs.randint(0, 256, (chans, h, w)) / 255.0).astype(np.float32)
    gain[:, 2, :] = ties
    gain[:, 3, :4] = [-0.1, 1.3, 0.0, 1.0]
    sdr[0, 5, 7] = gain[0, 6, 9] = np.nan
    rows = np.array([[gamma] * 3, [1.0, 0.9, 1.1], [4.9, 3.0, 2.5],
                     [1e-7, 0.0, 1.0 / 64], [1e-7, 0.5, 1.0 / 64]],
                    np.float32)
    return sdr, gain, rows


def pack_worst_case_stream():
    """Pack stream inputs (stream, dc_diff, is_luma) of blocks at the pack
    kernel's word cap, each once as luma and once as chroma: every AC
    coefficient at the 15-bit category (the undefined symbols have 0-bit
    codes: 15 bits a coefficient); every AC coefficient at 1023, size 10,
    the tables' longest AC codes; runs of 48 zeros, 3 ZRLs each, before
    coefficients 49 and 63; and DC diffs at categories 15 and 11."""
    blocks = np.zeros((4, 64), np.int16)
    blocks[0, 1:] = np.where(np.arange(63) % 2, 20000, -20000)
    blocks[1, 1:] = np.where(np.arange(63) % 2, 1023, -1023)
    blocks[2, [49, 63]] = [1023, -1023]
    blocks[3, 1:] = 1023
    dcd = np.array([-30000, 2047, -2047, 2047], np.int32)
    return (torch.from_numpy(np.concatenate([blocks, blocks])),
            torch.from_numpy(np.concatenate([dcd, dcd])),
            torch.from_numpy(np.repeat(np.int32([1, 0]), 4)))


def synthetic_slots(n: int, seed: int, dense=()):
    """(pays, lens) (n, 72) int32 slot inputs of the block pack and the
    tile pack at any block count, each payload below 2^length.  Most
    blocks look like photographic content: a DC slot of 2-11 bits, each of
    the next 15 slots of 2-16 bits with probability 1/2 and a 4-bit end
    slot, about 3-4 words; 1 in 50 has no bits at all.  Blocks in the
    [start, stop) ranges of `dense` fill 66 slots with 12-24 bits each
    (about 33 words, at most 1,584 of the 1,728 bits a buffer holds)."""
    rs = np.random.RandomState(seed)
    lens = np.zeros((n, pack_kernel._SLOTS), np.int64)
    lens[:, 0] = rs.randint(2, 12, n)
    lens[:, 1:16] = np.where(rs.rand(n, 15) < 0.5,
                             rs.randint(2, 17, (n, 15)), 0)
    lens[:, 16] = 4
    lens[rs.rand(n) < 0.02] = 0
    for start, stop in dense:
        lens[start:stop] = 0
        lens[start:stop, :66] = rs.randint(12, 25, (stop - start, 66))
    pays = (rs.random_sample(lens.shape) * (1 << lens)).astype(np.int64)
    return (torch.from_numpy(pays.astype(np.uint32).view(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


def _rand_words(rs, n: int) -> np.ndarray:
    return rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)


def unslice_edge_cases(seed: int = 15):
    """The un-slice kernel's edge cases (``csrc/wire_kernel.cu``: CTA runs
    of 256 groups, each run's word span staged from a 16-byte aligned
    middle and a few words at each end): (name, payload (int32), n, bits,
    widths (int32) or None, offsets (int32) or None, align).  `align` is
    the payload's word offset in a buffer whose start is 16-byte aligned
    (the staged span's shift); offsets None means the widths' exclusive
    prefix sums, as every caller passes them."""
    rs = np.random.RandomState(seed)
    out = []
    wid = rs.randint(0, 13, 300)            # two runs, the second partial
    live = int(wid.sum())
    for align in range(4):
        out.append((f"vw run ends mid-span, align {align}",
                    _rand_words(rs, live), 32 * 300 - 17, 0, wid, None,
                    align))
    wid = rs.randint(0, 13, 40)
    live = int(wid.sum())
    out.append(("vw clamp at the payload's end", _rand_words(rs, live - 7),
                32 * 40, 0, wid, None, 1))
    out.append(("vw offsets past the payload's end",
                _rand_words(rs, live // 3), 32 * 40 - 3, 0, wid, None, 2))
    out.append(("vw widths 0", _rand_words(rs, 1), 32 * 300, 0,
                np.zeros(300, np.int64), None, 3))
    out.append(("vw widths 12", _rand_words(rs, 12 * 300), 32 * 300, 0,
                np.full(300, 12), None, 3))
    out.append(("vw widths 0 and 12", _rand_words(rs, 12 * 150), 32 * 300,
                0, np.tile([0, 12], 150), None, 0))
    wid = rs.randint(0, 13, 300)
    out.append(("vw offsets no prefix sum (read from device memory)",
                _rand_words(rs, 20000), 32 * 300, 0, wid,
                rs.randint(-50, 20050, 300), 1))
    for bits in (1, 13, 20, 31):
        n = 32 * 300 + 5
        out.append((f"fixed {bits} bits over two runs",
                    _rand_words(rs, -(-n // 32) * bits), n, bits, None, None,
                    2))
    return [(name, pay, n, bits,
             None if w is None else w.astype(np.int32),
             None if o is None else o.astype(np.int32), align)
            for name, pay, n, bits, w, o, align in out]


def stitch_edge_cases(seed: int = 17):
    """The stitch kernel's edge cases (``csrc/stitch_kernel.cu``: 16-byte
    output groups, the image of a group's first word by binary search):
    (name, room (k, pitch) int32, counts (k,) int64).  One image; images of
    0 live words first, between and last; odd counts; totals of each
    residue mod 4 and under one group; full rows; counts past the pitch or
    below 0 (clamped); a pitch that is no multiple of 4; 64 images."""
    rs = np.random.RandomState(seed)

    def case(name, counts, pitch):
        counts = np.asarray(counts, np.int64)
        return (name, _rand_words(rs, len(counts) * pitch).reshape(
            len(counts), pitch), counts)

    out = [case("k = 1", [37], 37), case("k = 1, 0 live words", [0], 40),
           case("an image of 0 live words between", [5, 0, 9], 16),
           case("images of 0 live words first and last", [0, 0, 6, 0], 8),
           case("every image 0 live words", [0, 0, 0], 12),
           case("odd counts", [3, 7, 1, 13], 16),
           case("total under one group", [1, 2], 4),
           case("full rows", [24, 24, 24], 24),
           case("counts past the pitch and below 0", [30, -3, 4], 20),
           case("pitch no multiple of 4", [5, 11, 2], 13)]
    for total in (97, 98, 99, 100):
        out.append(case(f"total {total} (mod 4 = {total % 4})",
                        [total - 60, 60], 64))
    out.append(case("64 images", rs.randint(0, 300, 64), 300))
    return out


def aligned_tensor(arr: np.ndarray, align: int, device) -> torch.Tensor:
    """`arr` on `device` as a contiguous view that starts `align` 4-byte
    words past the start of its own allocation (itself 16-byte aligned),
    the case's alignment for the wire kernels' 16-byte copies."""
    flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(
        np.int32))
    buf = torch.empty(align + flat.numel(), dtype=torch.int32, device=device)
    buf[align:] = flat.to(device)
    return buf[align:].view(torch.from_numpy(arr[:0]).dtype).reshape(
        arr.shape)


def down_pack_edge_cases(seed: int = 15):
    """The download pack's edge cases (``csrc/wire_kernel.cu``: tiles of
    8,192 samples with the w + 1 samples before them as halo): (name,
    packed output (RGBA1010102 (h, w) int32 or RGBAF16 (h, w, 4) int16),
    bits, cap, align).  `align` is the output's word offset in a buffer
    whose start is 16-byte aligned (RGBAF16: 0 or 2)."""
    rs = np.random.RandomState(seed)

    def chans(h, w, noise, spikes=()):
        yy, xx = np.mgrid[0:h, 0:w]
        cs = [(300 + 2 * xx + yy + c * 50
               + (rs.randint(0, noise, (h, w)) if noise else 0)) % 1024
              for c in range(3)]
        for ch in cs:
            for p in spikes:
                ch.reshape(-1)[p] = 1023 - ch.reshape(-1)[p]
        return cs

    def rgba1010102(cs):
        return (cs[0] | cs[1] << 10 | cs[2] << 20 | 3 << 30).astype(
            np.uint32).view(np.int32)

    def rgbaf16(cs):
        h, w = cs[0].shape
        return np.stack([0x3000 + 16 * c for c in cs]
                        + [np.full((h, w), 0x3C00)], -1).astype(
                            np.uint16).view(np.int16)

    straddle = range(8192 - 6, 8192 + 6, 3)
    out = [("1x1", rgba1010102(chans(1, 1, 0, (0,))), 4, 8192, 0),
           ("h 1", rgba1010102(chans(1, 300, 400)), 3, 8192, 1),
           ("w 1", rgba1010102(chans(300, 1, 400)), 4, 8192, 2),
           ("w 53, f16", rgbaf16(chans(37, 53, 400)), 6, 16, 2),
           ("rows wider than a tile", rgba1010102(
               chans(2, 9000, 0, (0, 8999, 9000, 17999))), 4, 8192, 3),
           ("f16 rows wider than the halo's room", rgbaf16(
               chans(2, 20000, 0, (0, 19999, 20000, 39999))), 8, 8192, 0),
           ("escapes straddle a tile boundary", rgba1010102(
               chans(100, 100, 0, straddle)), 4, 8192, 1),
           ("cap in the middle of the first tile",
            rgba1010102(chans(100, 100, 12)), 4, 1000, 0),
           ("cap in the middle of the second tile",
            rgba1010102(chans(100, 100, 12)), 4, 2300, 3),
           ("count far past cap", rgbaf16(chans(100, 100, 400)), 3, 5, 0),
           ("interior tiles, column-0 escapes", rgba1010102(
               chans(200, 100, 12, range(8500, 16300, 700))), 4, 8192, 2)]
    return out


def dri_less_jpeg(kind: str, w: int, h: int, quality: int,
                  seed: int = 3) -> bytes:
    """A baseline JPEG of the photo scene without restart markers, from the
    general path's encoder on the CPU (``JpegEncoder.compress``): `kind`
    "420" (a 4:2:0 base), "444" (an RGB image coded 4:4:4, as a 3-channel
    gain map) or "400" (a 1-channel gain map)."""
    from .jpeg.encoder import JpegEncoder
    p010 = photo_p010(w, h, seed)
    y = (p010.planes[0] >> 8).astype(np.uint8)
    if kind == "400":
        fmt, planes = ImgFmt.YUV400, [y]
    elif kind == "420":
        uv = (p010.planes[1] >> 8).astype(np.uint8)
        fmt, planes = ImgFmt.YUV420, [y, np.ascontiguousarray(uv[:, 0::2]),
                                      np.ascontiguousarray(uv[:, 1::2])]
    else:
        fmt, planes = ImgFmt.RGB888, [np.stack(
            [y, np.roll(y, 3, 1), 255 - y], -1)]
    img = RawImage(fmt, ColorGamut.BT709, ColorTransfer.SRGB,
                   ColorRange.FULL, w, h, planes)
    return JpegEncoder(torch.device("cpu")).compress(img, quality)


def stuffed_jpeg(seed: int = 5) -> bytes:
    """A 64x48 4:2:0 JPEG whose scan is about a fifth FF bytes, each
    stuffed with a 00: coefficients whose magnitude bits are all ones, coded
    by the host coder (``native.encode_scan``), no restart markers."""
    from .jpeg.encoder import assemble_jpeg
    from .jpeg.tables import STD_CHROMA_QUANT, STD_LUMA_QUANT
    rng = np.random.default_rng(seed)
    mw, mh, sampling = 4, 3, [(2, 2), (1, 1), (1, 1)]
    comps = []
    for i, (h, v) in enumerate(sampling):
        c = ((1 << rng.integers(1, 11, (mh * v, mw * h, 64))) - 1) \
            * (rng.random((mh * v, mw * h, 64)) < 0.7)
        c[..., 0] = 1023
        comps.append({"coeffs": c.astype(np.int16), "h": h, "v": v,
                      "dc_tbl": min(i, 1), "ac_tbl": min(i, 1)})
    scan = native.encode_scan(comps, mw, mh, [DC_LUMA, DC_CHROMA, None, None],
                              [AC_LUMA, AC_CHROMA, None, None])
    return assemble_jpeg(mh * 16, mw * 16, sampling, STD_LUMA_QUANT,
                         STD_CHROMA_QUANT, scan)


def huffman_edge_cases() -> list[tuple[str, bytes, int]]:
    """(name, JPEG, subsequence bits) that the card's entropy decoder must
    decode as ``native.decode_scan`` does: 4:2:0 and 4:4:4 bases and 1-
    and 3-channel maps at qualities 50-100, subsequences of 32-64 bits (so
    that the sync runs many rounds) and of the default 1,024, a scan dense
    in FF 00 stuffing, and the ends of a scan: the padding bits then EOI,
    no EOI at all, and FF fill bytes before EOI."""
    base = dri_less_jpeg("420", 96, 64, 90)
    return [
        ("420 q50, 32-bit subsequences", dri_less_jpeg("420", 64, 48, 50), 32),
        ("420 q75, 64 bits", dri_less_jpeg("420", 104, 72, 75), 64),
        ("420 q90, 48 bits", base, 48),
        ("420 q100, 1024 bits", dri_less_jpeg("420", 200, 136, 100), 1024),
        ("444 q95, 64 bits", dri_less_jpeg("444", 96, 64, 95), 64),
        ("1-channel map q85, 32 bits", dri_less_jpeg("400", 120, 72, 85), 32),
        ("3-channel map q60, 40 bits", dri_less_jpeg("444", 64, 40, 60), 40),
        ("dense FF 00 stuffing, 32 bits", stuffed_jpeg(), 32),
        ("no EOI after the padding bits", base[:-2], 64),
        ("FF fill bytes before EOI", base[:-2] + b"\xff\xff\xff\xd9", 64),
    ]


def huffman_fault_cases() -> list[tuple[str, bytes]]:
    """(name, JPEG) streams that the host decodes only by its corrupt-data
    rules, which the card's entropy decoder must refuse (a nonzero status):
    a scan cut in half, an RST marker inside a scan that has no restart
    interval, and a run of stuffed FF bytes (64 ones, so some code is
    invalid) in the middle of the scan."""
    from .jpeg.decoder import parse_jpeg
    d = dri_less_jpeg("420", 128, 96, 90)
    off = parse_jpeg(d).scan_offset
    mid = off + (len(d) - off) // 2
    return [("truncated", d[:mid]),
            ("RST marker inside", d[:mid] + b"\xff\xd0" + d[mid:]),
            ("invalid code", d[:mid] + b"\xff\x00" * 8 + d[mid + 16:])]


def join_words(blen: np.ndarray, rs, fill=None) -> np.ndarray:
    """u32 words for blocks of `blen` bits laid out as the pack lays them
    (each block from a word boundary, zeros past its end): random bits, or
    the word `fill`."""
    wlen = (blen.astype(np.int64) + 31) >> 5
    total = int(wlen.sum())
    words = (np.full(total, fill, np.uint32) if fill is not None
             else rs.randint(0, 2 ** 32, total, dtype=np.uint64)
             .astype(np.uint32))
    tail = (blen % 32).astype(np.uint64)
    cut = (wlen > 0) & (tail > 0)
    words[(np.cumsum(wlen) - 1)[cut]] &= (
        (0xFFFFFFFF << (32 - tail[cut])) & 0xFFFFFFFF).astype(np.uint32)
    return words


def host_join(words: np.ndarray, blen: np.ndarray, parts) -> list[bytes]:
    """Each scan of a pack's output joined by ``native.join_blocks`` at its
    word offset: the reference of the restart-row join on the card."""
    from .jpeg import native
    out, w0, b0 = [], 0, 0
    for nb, bpr in parts:
        bl = blen[b0:b0 + nb]
        need = int(((bl.astype(np.int64) + 31) >> 5).sum())
        out.append(native.join_blocks(words[w0:w0 + need],
                                      bl.astype(np.uint16), bpr))
        w0, b0 = w0 + need, b0 + nb
    return out


def join_edge_cases() -> list[tuple[str, np.ndarray, np.ndarray, list]]:
    """(name, u32 words, blen, parts) inputs of the restart-row join
    (``jpeg/join_kernel``; parts [(blocks, blocks a row), ...] of scans
    packed back to back): random lengths up to a block's 1,984 bits,
    lengths that are multiples of 8 and of 32, one-block rows, a single
    row, rows whose pad byte is 0xFF, all-ones words (dense stuffing),
    blocks of 4-11 bits (many blocks a word), blocks of no bits, two
    scans back to back, and 19 rows (the RST markers cycle)."""
    cases = [  # name, parts, blen(rs), fill
        ("random", [(35, 7)], lambda rs: rs.randint(1, 1985, 35), None),
        ("multiples of 8 and 32", [(24, 6)], lambda rs: rs.choice(
            [8, 16, 24, 32, 64, 96, 256, 1984], 24), None),
        ("one-block rows", [(9, 1)], lambda rs: rs.randint(1, 200, 9), None),
        ("a single row", [(13, 13)], lambda rs: rs.randint(1, 300, 13),
         None),
        ("pad bytes 0xFF", [(12, 3)], lambda rs: np.array([13, 7, 9] * 4),
         0xFFFFFFFF),
        ("all ones", [(30, 5)], lambda rs: rs.randint(1, 1985, 30),
         0xFFFFFFFF),
        ("short blocks", [(120, 40)], lambda rs: rs.randint(4, 12, 120),
         None),
        ("empty blocks", [(24, 8)],
         lambda rs: rs.randint(0, 40, 24) * (rs.rand(24) < 0.6), None),
        ("two scans", [(24, 6), (15, 3)], lambda rs: rs.randint(1, 700, 39),
         None),
        ("19 rows of markers", [(38, 2)], lambda rs: rs.randint(1, 90, 38),
         None),
    ]
    out = []
    for i, (name, parts, blen, fill) in enumerate(cases):
        rs = np.random.RandomState(21 + i)
        b = blen(rs).astype(np.int64)
        out.append((name, join_words(b, rs, fill), b, parts))
    return out


def launch_ms(launch, reps: int = 20, before=None) -> float:
    """Mean ms of a kernel's launch() alone: an event pair around each
    launch, before() (if given) run ahead of it outside the pair, and the
    card kept busy (torch.cuda._sleep) until the launch is queued, so that
    the pair holds no host time.  The first launch is a warm-up."""
    pairs = []
    for _ in range(reps + 1):
        if before is not None:
            before()
        torch.cuda._sleep(200_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs[1:]) / reps


def pack_kernel_ms(ins, reps: int = 20) -> float:
    """Mean ms of the pack kernel alone on CUDA stream inputs `ins`, without
    its wrapper's read of the total (launch_ms; the scratch is zeroed
    before each launch)."""
    bufs = pack_kernel.PACK_KERNEL.buffers(ins[0].shape[0], ins[0].device)
    return launch_ms(lambda: pack_kernel.PACK_KERNEL.launch(*ins, *bufs),
                     reps, before=bufs[0].zero_)


def slot_pack_kernel_ms(kern, pays, lens, *extra, reps: int = 20) -> float:
    """Mean ms of the block pack (kern = PACK_BLOCKS_KERNEL, no extra) or
    the tile pack (PACK_TILES_KERNEL, extra = (budget,)) alone on CUDA
    slots, without its wrapper's checks and allocations (launch_ms)."""
    bufs = kern.buffers(pays.shape[0], *extra, pays.device)
    return launch_ms(lambda: kern.launch(pays, lens, *extra, *bufs), reps)


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
    """PSNR in dB of one packed output against another over R, G, B (the
    reference tests' ``_psnr_1010102`` / ``_psnr_f16``, infinite for equal
    outputs)."""
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


def progressive_jpegr(data: bytes, quality: int = 85,
                      subsampling: int = 2) -> bytes:
    """`data` (a JPEG_R file) with its base decoded and re-encoded as a
    progressive JPEG by PIL (4:2:0 by default, the base's ICC profile
    kept), wrapped with the file's own gain map and metadata through
    ``JpegR.encode_api4`` (host work only).  Imports PIL when called."""
    from PIL import Image

    from .jpegr import JpegR
    from .types import CompressedImage
    primary, _, gm_jpeg, _, metadata, cg, _ = JpegR._parse_jpegr(data)
    base = Image.open(io.BytesIO(primary))
    buf = io.BytesIO()
    base.convert("RGB").save(buf, "JPEG", progressive=True, quality=quality,
                             subsampling=subsampling,
                             icc_profile=base.info.get("icc_profile"))
    return JpegR(device="cpu").encode_api4(
        CompressedImage(buf.getvalue(), cg),
        CompressedImage(without_app_segments(gm_jpeg, keep_icc=True)),
        metadata)


def write_progressive_fixture(benchmark_file, out=PROGRESSIVE_FIXTURE):
    """Write ``progressive_jpegr`` of the benchmark configuration's 4K
    JPEG_R file (API-0 of ``photo_p010(3840, 2160)``, quality 95, map scale
    4, single-channel map) to `out`.  Make that file on a GPU, where the
    4K encode belongs, then rebuild the fixture where PIL is installed:

        python3 -c "from libultrahdr_tpu_torch import testing; \\
            testing.write_progressive_fixture('benchmark_3840x2160.jpg')"
    """
    data = progressive_jpegr(pathlib.Path(benchmark_file).read_bytes())
    pathlib.Path(out).write_bytes(data)
    return data


# ---------------------------------------------------------------------------
# the reference goldens (tests/goldens/*.npz)

# gates of the reference tests (tests/test_reference_goldens.py): a decode
# of the reference's bytes against the reference's decode; an encode of the
# golden's input, decoded, against the reference's decode of its own encode
# (both encoders lossy), and at most ENCODE_SLACK_DB below the anchor (the
# reference's bytes through the same decoder), capped at ANCHOR_CAP_DB; a
# resize effect (float bicubic on both sides)
DECODE_GATE_DB = 60.0
ENCODE_GATE_DB = 48.0
ANCHOR_CAP_DB = 60.0
ENCODE_SLACK_DB = 12.0
RESIZE_GATE_DB = 50.0


def golden_names() -> list[str]:
    """The goldens with decoded rasters (every file but the effects one),
    sorted."""
    names = sorted(p.stem for p in GOLDENS_DIR.glob("*.npz")
                   if not p.name.startswith("effects_"))
    if not names:
        raise FileNotFoundError(f"no goldens under {GOLDENS_DIR}")
    return names


def load_golden(name: str):
    """(the npz, its configuration dict) of golden `name`."""
    z = np.load(GOLDENS_DIR / f"{name}.npz")
    return z, json.loads(bytes(z["config"]).decode())


def golden_input(z, cfg: dict) -> RawImage:
    """A golden's raw input as the reference encoded it: P010, RGBAF16 or
    RGBA1010102, BT.2100, full range, its transfer from the config."""
    fmt = {0: ImgFmt.P010, 4: ImgFmt.RGBAF16, 5: ImgFmt.RGBA1010102}[
        cfg["fmt"]]
    ct = {0: ColorTransfer.LINEAR, 1: ColorTransfer.HLG,
          2: ColorTransfer.PQ}[cfg["ct"]]
    planes = [z[k] for k in sorted(z.files) if k.startswith("in_plane")]
    if fmt == ImgFmt.RGBA1010102:
        planes = [p.view(np.uint32) for p in planes]
    return RawImage(fmt, ColorGamut.BT2100, ct, ColorRange.FULL, cfg["w"],
                    cfg["h"], planes)


def golden_jpegr_knobs(cfg: dict) -> dict:
    """The ``JpegR`` keywords of a golden's encoder configuration."""
    from .types import EncPreset
    return dict(map_dimension_scale_factor=cfg["scale"],
                map_compress_quality=cfg["map_quality"],
                use_multi_channel_gainmap=cfg["multi"], gamma=cfg["gamma"],
                preset=EncPreset(cfg["preset"]),
                write_iso=cfg["metadata"] == "iso",
                write_xmp=cfg["metadata"] == "xmp")


@contextlib.contextmanager
def golden_metadata(cfg: dict):
    """The encoder API's metadata kind set to a golden's for the block:
    the reference chooses ISO or XMP when it is built (UHDR_WRITE_XMP,
    UHDR_WRITE_ISO), the port in ``container.jpegr_container``'s two
    switches, which a ``JpegR`` reads when it is made."""
    from .container import jpegr_container as jc
    saved = jc.WRITE_ISO_METADATA, jc.WRITE_XMP_METADATA
    jc.WRITE_ISO_METADATA = cfg["metadata"] == "iso"
    jc.WRITE_XMP_METADATA = cfg["metadata"] == "xmp"
    try:
        yield
    finally:
        jc.WRITE_ISO_METADATA, jc.WRITE_XMP_METADATA = saved


def golden_encoder(z, cfg: dict, device):
    """A ``UhdrEncoder`` on `device` holding a golden's input as the HDR
    intent, at the golden's quality, map scale, map quality, channels,
    gamma and preset; encode it inside ``golden_metadata(cfg)``."""
    from .api import UhdrEncoder
    from .types import EncPreset, ImgLabel
    enc = UhdrEncoder(device=device)
    enc.set_raw_image(golden_input(z, cfg), ImgLabel.HDR)
    enc.set_quality(cfg["quality"], ImgLabel.BASE)
    enc.set_quality(cfg["map_quality"], ImgLabel.GAIN_MAP)
    enc.set_gainmap_scale_factor(cfg["scale"])
    enc.set_using_multi_channel_gainmap(cfg["multi"])
    enc.set_gainmap_gamma(cfg["gamma"])
    enc.set_preset(EncPreset(cfg["preset"]))
    return enc


def golden_effects() -> list[tuple[str, list[tuple[str, tuple]]]]:
    """The effects golden's queues as the reference applied them: (name,
    [(kind, arguments), ...]) in the file's order."""
    _, cfg = load_golden(EFFECTS_GOLDEN)
    return [(name, [(kind, tuple(args)) for kind, args in queue])
            for name, queue in cfg["effects"]]


def queue_effects(ctx, queue):
    """Add a ``golden_effects`` queue to an encoder or decoder context."""
    for kind, args in queue:
        getattr(ctx, f"add_effect_{kind}")(*args)


def psnr_8888(got, want) -> float:
    """PSNR in dB of one RGBA8888 output against another over R, G, B (peak
    255; infinite for equal outputs)."""
    a, b = (np.stack([(np.asarray(x, np.uint32) >> s) & 0xFF
                      for s in (0, 8, 16)]).astype(np.float64)
            for x in (got, want))
    mse = np.mean((a - b) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))
