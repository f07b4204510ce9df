"""The fused single-device programs: the API-0 P010 encode and the decode.

Port of the P010 encode and the single-image decode of
``libultrahdr_tpu/fused.py``, with raw transfers (the vw/delta upload wires,
the coefficient wires and the download wire stay unported).

**Encode** (the JAX ``_fused_api0_p010``): raw P010 planes in, JPEG_R bytes
out.  On the device, in eager PyTorch plus the hand-written pack kernel:

1. P010 unpack                          (ops/pixel.unpack_p010)
2. tone map to 4:2:0 SDR                (ops/tonemap.tonemap_to_yuv)
3. one-pass gain map                    (ops/gainmap.generate_gainmap_onepass)
4. MCU pad, DCT and quantisation of the base and gain-map planes
                                        (_scan_coeffs, jpeg/dct.forward_plane)
5. Huffman symbols, bit packing and compaction of BOTH scans in one launch
                                        (jpeg/pack_kernel.pack_scan)

The host then downloads the words and block lengths once, joins each scan's
restart rows (native.join_blocks, shared C++), writes the JPEG headers
(jpeg/encoder.assemble_jpeg) and the MPF/ISO container
(container/jpegr_container.append_gainmap).  Both JPEGs carry one restart
interval per MCU row, as the JAX package's fused encode does.

**Decode** (the JAX ``_decode_device_core``): the host splits and parses the
file and Huffman-decodes both scans (``decode_coefficients``, shared C++),
uploads the raw int16 coefficient planes (``upload_coeff_planes``), and the
device runs, in eager PyTorch plus the hand-written apply kernel:

1. dequantisation and the bit-exact islow IDCT of every plane
                                        (jpeg/dct.inverse_plane)
2. chroma replication of the base       (ops/pixel.unpack_yuv8)
3. the gain map's YCbCr->RGB for a 3-channel map (jpeg/decoder._ycc_to_rgb)
4. the IDW upsample at scale > 1 and the apply-gainmap with the output
   packing                              (ops/apply.apply_gainmap_core)

The JAX ``_fused_decode`` is the jit wrapper of the same core; eager
PyTorch needs none.
"""

from __future__ import annotations

import numpy as np
import torch

from .container import icc as icc_mod
from .container import jpegr_container
from .jpeg import device_entropy, native, pack_kernel
from .jpeg.dct import forward_plane, inverse_plane
from .jpeg.decoder import (_validate, _ycc_to_rgb, get_output_sampling_format,
                           require_qtable)
from .jpeg.encoder import assemble_jpeg
from .jpeg.tables import STD_CHROMA_QUANT, STD_LUMA_QUANT, scaled_quant_table
from .ops import apply as apply_ops
from .ops import colors, gainmap as gainmap_ops, pixel
from .ops import tonemap as tonemap_ops
from .types import (ColorGamut, ColorRange, ColorTransfer, GainMapMetadata,
                    ImgFmt)

_SAMPLING_420 = ((2, 2), (1, 1), (1, 1))
_SAMPLING_444 = ((1, 1), (1, 1), (1, 1))
_SAMPLING_400 = ((1, 1),)


def _pad_edge(p: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate pad of an (h, w) plane to (ph, pw), any dtype."""
    h, w = p.shape
    if h == ph and w == pw:
        return p
    rows = torch.arange(ph, device=p.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=p.device).clamp(max=w - 1)
    return p.index_select(0, rows).index_select(1, cols)


def _rgb_to_ycbcr(rgb_u8_chw: torch.Tensor):
    """libjpeg full-range Rec.601 RGB->YCbCr (jccolor.c) on (3, H, W)."""
    r, g, b = (rgb_u8_chw[i].to(torch.float32) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return [torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)
            for p in (y, cb, cr)]


def _layout_for(h: int, w: int, sampling) -> device_entropy.ScanLayout:
    """The static scan layout of an (h, w) image."""
    hmax = max(hs for hs, _ in sampling)
    vmax = max(vs for _, vs in sampling)
    return device_entropy.scan_layout(tuple(sampling), -(-w // (8 * hmax)),
                                      -(-h // (8 * vmax)))


def _scan_coeffs(planes, sampling, qtables):
    """MCU-pad + DCT/quant a plane set; returns (coeffs, layout)."""
    h0, w0 = planes[0].shape
    layout = _layout_for(h0, w0, sampling)
    coeffs = []
    for p, (hs, vs), q in zip(planes, sampling, qtables):
        padded = _pad_edge(p, layout.mcus_h * vs * 8, layout.mcus_w * hs * 8)
        coeffs.append(forward_plane(padded, q))
    return coeffs, layout


def _api0_p010_block_buffers(y, uv, *, cg: ColorGamut, ct: ColorTransfer,
                             rng: ColorRange, scale: int, multichannel: bool,
                             gamma: float, quality: int, map_quality: int,
                             use_base_cg: bool):
    """P010 HDR planes on the device -> [(coeffs, layout)] for the base then
    the gain-map scan (steps 1-4)."""
    h, w = y.shape
    hdr_vals = pixel.unpack_p010(y, uv, rng, h, w)
    y8, u8, v8 = tonemap_ops.tonemap_to_yuv(hdr_vals, ImgFmt.P010, cg, ct)
    sdr_vals = pixel.unpack_yuv8(y8, u8, v8, 2, 2, h, w)
    max_boost = colors.reference_display_peak_nits(ct) / colors.SDR_WHITE_NITS
    gm = gainmap_ops.generate_gainmap_onepass(
        sdr_vals, hdr_vals, sdr_fmt=ImgFmt.YUV420, hdr_fmt=ImgFmt.P010,
        sdr_cg=ColorGamut.DISPLAY_P3, hdr_cg=cg, ct=ct, scale=scale,
        multichannel=multichannel, gamma=gamma, use_luminance=False,
        sdr_is_601=False, use_base_cg=use_base_cg, max_boost=max_boost)

    qluma = scaled_quant_table(STD_LUMA_QUANT, quality)
    qchroma = scaled_quant_table(STD_CHROMA_QUANT, quality)
    base = _scan_coeffs([y8, u8, v8], _SAMPLING_420, [qluma, qchroma, qchroma])
    mq_luma = scaled_quant_table(STD_LUMA_QUANT, map_quality)
    mq_chroma = scaled_quant_table(STD_CHROMA_QUANT, map_quality)
    if multichannel:
        gmap = _scan_coeffs(_rgb_to_ycbcr(gm), _SAMPLING_444,
                            [mq_luma, mq_chroma, mq_chroma])
    else:
        gmap = _scan_coeffs([gm[0]], _SAMPLING_400, [mq_luma])
    return [base, gmap]


def _fused_api0_p010_body(y, uv, *, pack=pack_kernel.pack_scan, **kw):
    """P010 HDR planes on the device -> (words, blen_all, scans): both
    scans' streams concatenated and packed in ONE launch, so the host drains
    each image with one download of words and one of block lengths.
    `scans` are the [(coeffs, layout)] the words were packed from; `pack`
    is the entropy stage (the dispatcher, or its plain version to compare
    against)."""
    scans = _api0_p010_block_buffers(y, uv, **kw)
    inputs = [device_entropy.stream_inputs(c, lay) for c, lay in scans]
    words, blen = pack(*(torch.cat(parts) for parts in zip(*inputs)))
    return words, blen, scans


def fetch_blocks_multi(words: np.ndarray, parts) -> list[bytes]:
    """Join several scans packed back-to-back in one host word buffer.

    parts: [(block_len_bits u16, bpr), ...] in packing order.  Returns the
    joined scan bytes per part."""
    out, off = [], 0
    for bl, bpr in parts:
        need = device_entropy.total_words(bl)
        out.append(native.join_blocks(words[off:off + need], bl, bpr))
        off += need
    return out


def _onepass_metadata(jr, ct: ColorTransfer,
                      use_base_cg: bool) -> GainMapMetadata:
    """One-pass metadata is closed-form (jpegr.cpp:712-828)."""
    max_boost = colors.reference_display_peak_nits(ct) / colors.SDR_WHITE_NITS
    md = GainMapMetadata()
    md.max_content_boost[:] = max_boost
    md.min_content_boost[:] = 1.0
    md.gamma[:] = jr.gamma
    md.offset_sdr[:] = 0.0
    md.offset_hdr[:] = 0.0
    md.hdr_capacity_min = 1.0
    md.hdr_capacity_max = (jr.target_disp_peak_brightness / colors.SDR_WHITE_NITS
                           if jr.target_disp_peak_brightness != -1.0
                           else max_boost)
    md.use_base_cg = use_base_cg
    return md


def _assemble_container(jr, w, h, quality, base_scan, base_sampling,
                        icc_cg, scale, gm_scan, metadata, exif,
                        gm_ct, gm_cg) -> bytes:
    quality = int(quality)
    qluma = scaled_quant_table(STD_LUMA_QUANT, quality)
    qchroma = scaled_quant_table(STD_CHROMA_QUANT, quality)
    hmax = base_sampling[0][0]
    base_jpeg = assemble_jpeg(h, w, list(base_sampling), qluma, qchroma,
                              base_scan,
                              icc=icc_mod.write_icc_profile(
                                  ColorTransfer.SRGB, icc_cg),
                              dri=-(-w // (8 * hmax)))
    mq_luma = scaled_quant_table(STD_LUMA_QUANT, jr.map_compress_quality)
    mq_chroma = scaled_quant_table(STD_CHROMA_QUANT, jr.map_compress_quality)
    mh, mw = h // scale, w // scale
    gm_icc = None
    if not jr.write_xmp:
        gm_icc = icc_mod.write_icc_profile(gm_ct, gm_cg)
    sampling = _SAMPLING_444 if jr.use_multi_channel_gainmap else _SAMPLING_400
    gm_jpeg = assemble_jpeg(mh, mw, list(sampling), mq_luma, mq_chroma,
                            gm_scan, icc=gm_icc, gainmap_comment=True,
                            dri=-(-mw // 8))
    return jpegr_container.append_gainmap(
        base_jpeg, gm_jpeg, metadata, exif=exif, icc=None,
        write_iso=jr.write_iso, write_xmp=jr.write_xmp)


def _resolve_scale(jr, img) -> int:
    """The map scale the encode uses; an unusable factor is replaced (and
    written back into the knob) as the reference does."""
    scale = jr.map_dimension_scale_factor
    if scale <= 0 or img.w // scale == 0 or img.h // scale == 0:
        s = min(img.w, img.h)
        scale = s // 8 if s >= 8 else 1
        jr.map_dimension_scale_factor = scale
    return scale


def upload_p010(img, device: torch.device):
    """Raw upload of the two P010 planes as int16 views of their u16
    samples (one copy each, no repacking)."""
    return [torch.from_numpy(
        np.ascontiguousarray(p, np.uint16).view(np.int16)).to(device)
        for p in img.planes[:2]]


def encode_api0_p010_fused(jr, img, quality: int, exif: bytes | None, *,
                           pack=pack_kernel.pack_scan) -> bytes:
    """JpegR.encode_api0 on P010 input, on `jr.device`.

    API-0 SDR is always tone-mapped into P3 (jpegr.cpp:1985-1987), so the
    gamut-space selection (jpegr.cpp:600-646) reduces to
    cg != BT2100 or write_xmp."""
    cg, ct = ColorGamut(img.cg), ColorTransfer(img.ct)
    scale = _resolve_scale(jr, img)
    use_base_cg = (cg != ColorGamut.BT2100) or bool(jr.write_xmp)
    y, uv = upload_p010(img, jr.device)
    words, blen, scans = _fused_api0_p010_body(
        y, uv, pack=pack, cg=cg, ct=ct, rng=ColorRange(img.range),
        scale=scale, multichannel=jr.use_multi_channel_gainmap,
        gamma=jr.gamma, quality=int(quality),
        map_quality=jr.map_compress_quality, use_base_cg=use_base_cg)
    words_h = words.cpu().numpy().view(np.uint32)
    blen_h = blen.cpu().numpy().astype(np.uint16)
    (_, bl), (_, gl) = scans
    n_base = bl.mcus_h * bl.bpr
    base_scan, gm_scan = fetch_blocks_multi(
        words_h, [(blen_h[:n_base], bl.bpr), (blen_h[n_base:], gl.bpr)])
    metadata = _onepass_metadata(jr, ct, use_base_cg)
    return _assemble_container(jr, img.w, img.h, quality, base_scan,
                               _SAMPLING_420, ColorGamut.DISPLAY_P3, scale,
                               gm_scan, metadata, exif, ct, cg)


# ---------------------------------------------------------------------------
# decode

# chroma subsampling (h, v) of the base per sampling key
DECODE_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}


def decode_coefficients(data: bytes, info):
    """Host Huffman decode to MCU-padded coefficient arrays + natural-order
    quant tables per component (the jpeg/decoder.py front half, without the
    device IDCT)."""
    _validate(info)
    fmt = get_output_sampling_format(info) if info.num_components > 1 \
        else ImgFmt.YUV400
    hmax = max(c.h for c in info.components)
    vmax = max(c.v for c in info.components)
    mcus_w = -(-info.width // (8 * hmax))
    mcus_h = -(-info.height // (8 * vmax))
    comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
             for c in info.components]
    dc = [info.dc_tables.get(i) for i in range(4)]
    ac = [info.ac_tables.get(i) for i in range(4)]
    coeffs, _ = native.decode_scan(data[info.scan_offset:], comps, mcus_w,
                                   mcus_h, dc, ac, info.restart_interval)
    qts = [np.asarray(require_qtable(info, c), np.int32)
           for c in info.components]
    return coeffs, qts, fmt


def upload_coeff_planes(planes, device: torch.device):
    """Raw upload of (bh, bw, 64) int16 coefficient planes, one copy each."""
    return [torch.from_numpy(np.ascontiguousarray(c, np.int16)).to(device)
            for c in planes]


def _decode_sdr_and_gain(base_coeffs, base_qts, gm_coeffs, gm_qts, *, h: int,
                         w: int, sampling_key: str, gm_channels: int,
                         scale_k: int):
    """Coefficient planes on the device -> (SDR YUV (3,h,w) float32, gain
    map (C, h/k, w/k) uint8): dequant + islow IDCT of both images, chroma
    replication of the base, YCbCr->RGB of a 3-channel map."""
    hf, vf = DECODE_SAMPLING[sampling_key]
    planes = [inverse_plane(c, q, -(-h // (vf if i else 1)),
                            -(-w // (hf if i else 1)))
              for i, (c, q) in enumerate(zip(base_coeffs, base_qts))]
    sdr_yuv = pixel.unpack_yuv8(planes[0], planes[1], planes[2], hf, vf, h, w)
    mh, mw = h // scale_k, w // scale_k
    gm = [inverse_plane(c, q, mh, mw) for c, q in zip(gm_coeffs, gm_qts)]
    gm_u8 = gm[0][None] if gm_channels == 1 \
        else _ycc_to_rgb(gm[0], gm[1], gm[2], "444", mh, mw)
    return sdr_yuv, gm_u8


def _decode_device_core(base_coeffs, base_qts, gm_coeffs, gm_qts,
                        meta_arrays, weight, *, h: int, w: int,
                        sampling_key: str, gm_channels: int, scale_k: int,
                        out_ct: ColorTransfer, sdr_cg: ColorGamut,
                        hdr_cg: ColorGamut, use_base_cg: bool):
    """Device half of decode on the coefficients' device: dequant + IDCT of
    base and gain map + apply-gainmap + output packing (the
    jpegr.cpp:1384-1699 pipeline with the entropy decode left on host).
    Returns (packed output, gain map u8 (C, mh, mw))."""
    sdr_yuv, gm_u8 = _decode_sdr_and_gain(
        base_coeffs, base_qts, gm_coeffs, gm_qts, h=h, w=w,
        sampling_key=sampling_key, gm_channels=gm_channels, scale_k=scale_k)
    packed = apply_ops.apply_gainmap_core(
        sdr_yuv, gm_u8, meta_arrays, scale_k=scale_k, weight=weight,
        out_ct=out_ct, sdr_cg=sdr_cg, hdr_cg=hdr_cg, use_base_cg=use_base_cg)
    return packed, gm_u8
