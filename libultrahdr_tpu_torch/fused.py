"""The fused single-device programs: the API-0 and API-1 encodes and the
decode.

Port of the API-0 and API-1 encodes and the single-image decode of
``libultrahdr_tpu/fused.py``, with raw transfers (the vw/delta upload wires,
the RGB channel wires, the coefficient wires and the download wire stay
unported).

**Encode** (the JAX ``_fused_api0_p010``, ``_fused_api0_rgb`` and
``_fused_api0_yuv444_10``): raw HDR planes in, JPEG_R bytes out.  On the
device, in eager PyTorch plus the hand-written pack kernel:

1. unpack: P010, RGBA1010102, RGBAF16 (sanitized) or YUV444_10
                                        (ops/pixel.unpack_*)
2. tone map to the SDR: 4:2:0 planes for P010, an RGBA8888 image for the RGB
   formats, 4:4:4 planes for YUV444_10  (ops/tonemap.tonemap_to_*)
3. one-pass gain map                    (ops/gainmap.generate_gainmap_onepass)
4. MCU pad, DCT and quantisation of the base (4:2:0 for P010, else 4:4:4,
   an RGB SDR through its P3 YCbCr) and gain-map planes
                                        (_scan_coeffs, jpeg/dct.forward_plane)
5. Huffman symbols, bit packing and compaction of BOTH scans in one launch
                                        (jpeg/pack_kernel.pack_scan)

**API-1** (the JAX ``_fused_api1`` and ``_fused_api1_gm``): raw HDR (P010,
RGBA1010102, RGBAF16) and raw SDR (YUV420, RGBA8888) planes in.  The SDR
is the base: its YUV encoding converted to Display-P3's BT.601
(``_convert_yuv_encoding_planes``; an RGBA8888 SDR through its own gamut's
YCbCr first), MCU-padded and transformed as in step 4; the gain map is
made from the SDR and the HDR with the luminance metric.  REALTIME makes
the one-pass map (step 3).  BEST_QUALITY (the library's default) makes
the two-pass map: float gains and their per-channel min/max on the device,
the 2C floats read to the host (the request's one synchronisation before
the pack), the bounds resolved there (user boosts, the XMP channel merge),
then the map quantised on the device.  Either way both scans go through
ONE pack launch.  The JAX package packs the base before the bound
resolution; the port resolves the bounds first so that one launch packs
both scans; the bytes are the same.

The host then downloads the words and block lengths once, joins each scan's
restart rows (native.join_blocks, host C++), writes the JPEG headers
(jpeg/encoder.assemble_jpeg) and the MPF/ISO container
(container/jpegr_container.append_gainmap).  Both JPEGs carry one restart
interval per MCU row, as the JAX package's fused encode does.  The JAX
package packs the two scans apart; the joined bytes are the same.

**Decode** (the JAX ``_decode_device_core``): the host splits and parses the
file and Huffman-decodes both scans (``decode_coefficients``, host C++),
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
from .jpeg.decoder import _ycc_to_rgb
from .jpeg.decoder import decode_coefficients  # noqa: F401  (the decode's)
from .jpeg.encoder import assemble_jpeg
from .jpeg.encoder import pad_edge as _pad_edge
from .jpeg.encoder import rgb_to_ycbcr as _rgb_to_ycbcr
from .jpeg.tables import STD_CHROMA_QUANT, STD_LUMA_QUANT, scaled_quant_table
from .ops import apply as apply_ops
from .ops import colors, gainmap as gainmap_ops, pixel
from .ops import tonemap as tonemap_ops
from .types import (ColorGamut, ColorRange, ColorTransfer, EncPreset,
                    GainMapMetadata, ImgFmt)

_SAMPLING_420 = ((2, 2), (1, 1), (1, 1))
_SAMPLING_444 = ((1, 1), (1, 1), (1, 1))
_SAMPLING_400 = ((1, 1),)


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


def _gainmap_scan(gm, multichannel: bool, map_quality: int):
    """The gain map's (coeffs, layout): a 3-channel map as 4:4:4 YCbCr, a
    1-channel map as 4:0:0 (the JAX ``_pack_gainmap`` without its pack: the
    port packs both scans of a request in one launch)."""
    mq_luma = scaled_quant_table(STD_LUMA_QUANT, map_quality)
    mq_chroma = scaled_quant_table(STD_CHROMA_QUANT, map_quality)
    if multichannel:
        return _scan_coeffs(_rgb_to_ycbcr(gm), _SAMPLING_444,
                            [mq_luma, mq_chroma, mq_chroma])
    return _scan_coeffs([gm[0]], _SAMPLING_400, [mq_luma])


def _base_scan(planes, sampling, quality: int):
    """The base image's (coeffs, layout) from its Y, Cb, Cr u8 planes."""
    qluma = scaled_quant_table(STD_LUMA_QUANT, quality)
    qchroma = scaled_quant_table(STD_CHROMA_QUANT, quality)
    return _scan_coeffs(planes, sampling, [qluma, qchroma, qchroma])


def _onepass_gainmap(sdr_vals, hdr_vals, *, sdr_fmt: ImgFmt, hdr_fmt: ImgFmt,
                     cg: ColorGamut, ct: ColorTransfer, scale: int,
                     multichannel: bool, gamma: float, use_base_cg: bool):
    """The API-0 one-pass gain map against the tone-mapped (Display-P3)
    SDR."""
    max_boost = colors.reference_display_peak_nits(ct) / colors.SDR_WHITE_NITS
    return gainmap_ops.generate_gainmap_onepass(
        sdr_vals, hdr_vals, sdr_fmt=sdr_fmt, hdr_fmt=hdr_fmt,
        sdr_cg=ColorGamut.DISPLAY_P3, hdr_cg=cg, ct=ct, scale=scale,
        multichannel=multichannel, gamma=gamma, use_luminance=False,
        sdr_is_601=False, use_base_cg=use_base_cg, max_boost=max_boost)


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
    gm = _onepass_gainmap(sdr_vals, hdr_vals, sdr_fmt=ImgFmt.YUV420,
                          hdr_fmt=ImgFmt.P010, cg=cg, ct=ct, scale=scale,
                          multichannel=multichannel, gamma=gamma,
                          use_base_cg=use_base_cg)
    return [_base_scan([y8, u8, v8], _SAMPLING_420, quality),
            _gainmap_scan(gm, multichannel, map_quality)]


def _rgb_vals_to_yuv444_planes(rgb_vals, cg: ColorGamut):
    """convert_raw_input_to_ycbcr without chroma sampling
    (gainmapmath.cpp:1291-1501 RGBA8888 branch): (3,H,W) [0,1] -> 3 u8."""
    yuv = colors.apply_3x3(colors.rgb2yuv_matrix_for_gamut(cg), rgb_vals)
    y = torch.clamp(yuv[0] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    u = torch.clamp(yuv[1] * 255.0 + 0.5 + 128.0, 0, 255).to(torch.uint8)
    v = torch.clamp(yuv[2] * 255.0 + 0.5 + 128.0, 0, 255).to(torch.uint8)
    return y, u, v


def _api0_rgb_block_buffers(packed, *, fmt: ImgFmt, cg: ColorGamut,
                            ct: ColorTransfer, scale: int,
                            multichannel: bool, gamma: float, quality: int,
                            map_quality: int, use_base_cg: bool):
    """Packed RGBA1010102 ((H, W) int32) or RGBAF16 ((H, W, 4) int16) HDR on
    the device -> [(coeffs, layout)] of the base and the gain-map scan (the
    JAX ``_fused_api0_rgb``): tone map to an RGBA8888 SDR
    (jpegr.cpp:2040-2042), the gain map from it, a 4:4:4 base."""
    if fmt == ImgFmt.RGBA1010102:
        hdr_vals = pixel.unpack_rgba1010102(packed)
    else:
        hdr_vals = pixel.unpack_rgbaf16(packed)
    sdr_vals = pixel.unpack_rgba8888(
        tonemap_ops.tonemap_to_rgba8888(hdr_vals, fmt, cg, ct))
    gm = _onepass_gainmap(sdr_vals, hdr_vals, sdr_fmt=ImgFmt.RGBA8888,
                          hdr_fmt=fmt, cg=cg, ct=ct, scale=scale,
                          multichannel=multichannel, gamma=gamma,
                          use_base_cg=use_base_cg)
    planes = _rgb_vals_to_yuv444_planes(sdr_vals, ColorGamut.DISPLAY_P3)
    return [_base_scan(planes, _SAMPLING_444, quality),
            _gainmap_scan(gm, multichannel, map_quality)]


def _api0_yuv444_10_block_buffers(y, u, v, *, cg: ColorGamut,
                                  ct: ColorTransfer, rng: ColorRange,
                                  scale: int, multichannel: bool,
                                  gamma: float, quality: int,
                                  map_quality: int, use_base_cg: bool):
    """30bpp YCbCr444 HDR planes on the device -> [(coeffs, layout)] of the
    base and the gain-map scan (the JAX ``_fused_api0_yuv444_10``,
    jpegr.cpp:178-190: an 8-bit YUV444 SDR, a 4:4:4 base)."""
    h, w = y.shape
    hdr_vals = pixel.unpack_yuv444_10(y, u, v, rng)
    y8, u8, v8 = tonemap_ops.tonemap_to_yuv(hdr_vals, ImgFmt.YUV444_10, cg,
                                            ct, out_yuv420=False)
    sdr_vals = pixel.unpack_yuv8(y8, u8, v8, 1, 1, h, w)
    gm = _onepass_gainmap(sdr_vals, hdr_vals, sdr_fmt=ImgFmt.YUV444,
                          hdr_fmt=ImgFmt.YUV444_10, cg=cg, ct=ct,
                          scale=scale, multichannel=multichannel,
                          gamma=gamma, use_base_cg=use_base_cg)
    return [_base_scan([y8, u8, v8], _SAMPLING_444, quality),
            _gainmap_scan(gm, multichannel, map_quality)]


def _pack_scans(scans, pack):
    """Both scans' streams concatenated and packed in ONE launch, so the
    host drains a request with one download of words and one of block
    lengths; `pack` is the entropy stage (the dispatcher, or its plain
    version to compare against)."""
    inputs = [device_entropy.stream_inputs(c, lay) for c, lay in scans]
    return pack(*(torch.cat(parts) for parts in zip(*inputs)))


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


def _convert_yuv_encoding_planes(planes, fmt: ImgFmt, src_cg: ColorGamut,
                                 dst_cg: ColorGamut, h: int, w: int):
    """convert_yuv_encoding (transformYuv420/444, gainmapmath.cpp:686-748)
    on the device; the planes unchanged when the encodings match.  A
    4:2:0 image's converted chroma is constant over each 2x2 quad (the
    matrix rows for u', v' have no y term), so one sample a quad is taken."""
    m = colors.yuv_encoding_conversion_matrix(src_cg, dst_cg)
    if m is None:
        return planes
    sub = 2 if fmt == ImgFmt.YUV420 else 1
    out = colors.apply_3x3(m, pixel.unpack_yuv8(*planes, sub, sub, h, w))
    y = torch.clamp(out[0] * 255.0 + 0.5, 0, 255).to(torch.uint8)
    if fmt == ImgFmt.YUV420:
        h2, w2 = (h // 2) * 2, (w // 2) * 2
        u, v = out[1][:h2:2, :w2:2], out[2][:h2:2, :w2:2]
    else:
        u, v = out[1], out[2]
    return (y, torch.clamp(u * 255.0 + 128.5, 0, 255).to(torch.uint8),
            torch.clamp(v * 255.0 + 128.5, 0, 255).to(torch.uint8))


def _api1_block_buffers(hdr_planes, sdr_planes, *, hdr_fmt: ImgFmt,
                        sdr_fmt: ImgFmt, hdr_cg: ColorGamut,
                        sdr_cg: ColorGamut, ct: ColorTransfer,
                        rng: ColorRange, scale: int, multichannel: bool,
                        gamma: float, quality: int, map_quality: int,
                        use_base_cg: bool, one_pass: bool):
    """API-1 stage 1 (the JAX ``_fused_api1``, jpegr.cpp:236-295) on the
    device.  hdr_planes: P010 (y, uv) or the packed RGB plane; sdr_planes:
    YUV420 (y, u, v) or the packed RGBA8888 plane.

    One-pass: [(coeffs, layout)] of the base and the gain-map scan.
    Two-pass: (the base's (coeffs, layout), gains, gmin, gmax) -- the
    bounds are resolved on the host, then ``_api1_gainmap_scan``
    quantises."""
    h, w = hdr_planes[0].shape[:2]
    if hdr_fmt == ImgFmt.P010:
        hdr_vals = pixel.unpack_p010(*hdr_planes, rng, h, w)
    elif hdr_fmt == ImgFmt.RGBA1010102:
        hdr_vals = pixel.unpack_rgba1010102(hdr_planes[0])
    else:
        hdr_vals = pixel.unpack_rgbaf16(hdr_planes[0])
    if sdr_fmt == ImgFmt.YUV420:
        sdr_vals = pixel.unpack_yuv8(*sdr_planes, 2, 2, h, w)
        planes = _convert_yuv_encoding_planes(
            sdr_planes, ImgFmt.YUV420, sdr_cg, ColorGamut.DISPLAY_P3, h, w)
        base = _base_scan(list(planes), _SAMPLING_420, quality)
    else:  # RGBA8888
        sdr_vals = pixel.unpack_rgba8888(sdr_planes[0])
        planes = _convert_yuv_encoding_planes(
            _rgb_vals_to_yuv444_planes(sdr_vals, sdr_cg), ImgFmt.YUV444,
            sdr_cg, ColorGamut.DISPLAY_P3, h, w)
        base = _base_scan(list(planes), _SAMPLING_444, quality)
    common = dict(sdr_fmt=sdr_fmt, hdr_fmt=hdr_fmt, sdr_cg=sdr_cg,
                  hdr_cg=hdr_cg, ct=ct, scale=scale,
                  multichannel=multichannel, use_luminance=True,
                  sdr_is_601=False, use_base_cg=use_base_cg)
    if one_pass:
        max_boost = (colors.reference_display_peak_nits(ct)
                     / colors.SDR_WHITE_NITS)
        gm = gainmap_ops.generate_gainmap_onepass(
            sdr_vals, hdr_vals, gamma=gamma, max_boost=max_boost, **common)
        return [base, _gainmap_scan(gm, multichannel, map_quality)]
    gains, gmin, gmax = gainmap_ops.gainmap_float_pass(sdr_vals, hdr_vals,
                                                       **common)
    return base, gains, gmin, gmax


def _api1_gainmap_scan(gains, lo, hi, gamma: float, *, multichannel: bool,
                       map_quality: int):
    """API-1 two-pass stage 2 (the JAX ``_fused_api1_gm``): the map
    quantised with the resolved bounds, then its (coeffs, layout)."""
    gm = gainmap_ops.encode_gainmap_twopass(gains, lo, hi, gamma)
    return _gainmap_scan(gm, multichannel, map_quality)


def _twopass_metadata(jr, ct: ColorTransfer, lo: np.ndarray, hi: np.ndarray,
                     use_base_cg: bool) -> GainMapMetadata:
    """Two-pass metadata from the resolved log2 bounds (jpegr.cpp:947-1027):
    one value per channel of a 3-channel map, else the one value for all."""
    md = GainMapMetadata()
    if jr.use_multi_channel_gainmap:
        md.max_content_boost[:] = np.exp2(np.resize(hi, 3))
        md.min_content_boost[:] = np.exp2(np.resize(lo, 3))
    else:
        md.max_content_boost[:] = np.exp2(hi[0])
        md.min_content_boost[:] = np.exp2(lo[0])
    md.gamma[:] = jr.gamma
    md.offset_sdr[:] = colors.SDR_OFFSET
    md.offset_hdr[:] = colors.HDR_OFFSET
    md.hdr_capacity_min = 1.0
    hdr_white = colors.reference_display_peak_nits(ct)
    md.hdr_capacity_max = (jr.target_disp_peak_brightness
                           / colors.SDR_WHITE_NITS
                           if jr.target_disp_peak_brightness != -1.0
                           else hdr_white / colors.SDR_WHITE_NITS)
    md.use_base_cg = use_base_cg
    return md


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


def _use_base_cg(sdr_cg: ColorGamut, hdr_cg: ColorGamut, write_xmp) -> bool:
    """Gamut-application-space selection (jpegr.cpp:600-646)."""
    if sdr_cg == hdr_cg:
        return True
    return bool(write_xmp) or not (
        hdr_cg == ColorGamut.BT2100
        or (hdr_cg == ColorGamut.DISPLAY_P3 and sdr_cg != ColorGamut.BT2100))


def upload_planes(planes, device: torch.device):
    """Raw upload of sample planes, 16- or 32-bit ones as int16 / int32
    views of their unsigned samples (one copy each, no repacking)."""
    return [pixel.plane_tensor(p, device) for p in planes]


def _p010_planes(img):
    return [np.asarray(p, np.uint16) for p in img.planes[:2]]


def upload_p010(img, device: torch.device):
    """Raw upload of the two P010 planes as int16 views of their u16
    samples."""
    return upload_planes(_p010_planes(img), device)


def _pack_and_assemble(jr, w: int, h: int, quality: int, scans,
                       base_sampling, icc_cg: ColorGamut, scale: int,
                       metadata: GainMapMetadata, exif: bytes | None,
                       gm_ct: ColorTransfer, gm_cg: ColorGamut, pack) -> bytes:
    """The back half of a fused encode: one `pack` of both scans on the
    device, one download, the host join of each scan and the container."""
    words, blen = _pack_scans(scans, pack)
    words_h = words.cpu().numpy().view(np.uint32)
    blen_h = blen.cpu().numpy().astype(np.uint16)
    (_, bl), (_, gl) = scans
    n_base = bl.mcus_h * bl.bpr
    base_scan, gm_scan = fetch_blocks_multi(
        words_h, [(blen_h[:n_base], bl.bpr), (blen_h[n_base:], gl.bpr)])
    return _assemble_container(jr, w, h, quality, base_scan, base_sampling,
                               icc_cg, scale, gm_scan, metadata, exif, gm_ct,
                               gm_cg)


def _encode_api0(jr, img, quality: int, exif: bytes | None, block_buffers,
                 planes, base_sampling, pack, **kw) -> bytes:
    """The API-0 encode of one HDR image on `jr.device`: upload `planes`,
    run `block_buffers` (steps 1-4) and one `pack` of both scans on the
    device, download once, join both scans and write the container.
    API-0 SDR is always tone-mapped into P3 (jpegr.cpp:1985-1987)."""
    cg, ct = ColorGamut(img.cg), ColorTransfer(img.ct)
    scale = _resolve_scale(jr, img)
    use_base_cg = _use_base_cg(ColorGamut.DISPLAY_P3, cg, jr.write_xmp)
    scans = block_buffers(
        *upload_planes(planes, jr.device), cg=cg, ct=ct, scale=scale,
        multichannel=jr.use_multi_channel_gainmap, gamma=jr.gamma,
        quality=int(quality), map_quality=jr.map_compress_quality,
        use_base_cg=use_base_cg, **kw)
    return _pack_and_assemble(
        jr, img.w, img.h, quality, scans, base_sampling,
        ColorGamut.DISPLAY_P3, scale, _onepass_metadata(jr, ct, use_base_cg),
        exif, ct, cg, pack)


def encode_api0_p010_fused(jr, img, quality: int, exif: bytes | None, *,
                           pack=pack_kernel.pack_scan) -> bytes:
    """JpegR.encode_api0 on P010 input (4:2:0 base)."""
    return _encode_api0(jr, img, quality, exif, _api0_p010_block_buffers,
                        _p010_planes(img), _SAMPLING_420, pack,
                        rng=ColorRange(img.range))


def encode_api0_rgb_fused(jr, img, quality: int, exif: bytes | None, *,
                          pack=pack_kernel.pack_scan) -> bytes:
    """JpegR.encode_api0 on packed RGBA1010102 (u32 words) or RGBAF16
    ((H, W, 4) half floats or their u16 patterns) input (4:4:4 base), with
    a raw upload."""
    return _encode_api0(jr, img, quality, exif, _api0_rgb_block_buffers,
                        img.planes[:1], _SAMPLING_444, pack,
                        fmt=ImgFmt(img.fmt))


def encode_api0_yuv444_10_fused(jr, img, quality: int, exif: bytes | None,
                                *, pack=pack_kernel.pack_scan) -> bytes:
    """JpegR.encode_api0 on YUV444_10 input (three u16 planes of 10-bit
    samples; 4:4:4 base)."""
    return _encode_api0(
        jr, img, quality, exif, _api0_yuv444_10_block_buffers,
        [np.asarray(p, np.uint16) for p in img.planes[:3]], _SAMPLING_444,
        pack, rng=ColorRange(img.range))


API1_HDR_FORMATS = (ImgFmt.P010, ImgFmt.RGBA1010102, ImgFmt.RGBAF16)
API1_SDR_FORMATS = (ImgFmt.YUV420, ImgFmt.RGBA8888)


def api1_bounds(jr, gmin: torch.Tensor, gmax: torch.Tensor):
    """The two-pass boost bounds (lo, hi) resolved on the host from the
    device's per-channel min/max: one read of those 2C floats."""
    mm = torch.stack([gmin, gmax]).cpu().numpy()
    return gainmap_ops.resolve_boost_bounds(
        mm[0], mm[1], multichannel=jr.use_multi_channel_gainmap,
        min_content_boost=jr.min_content_boost,
        max_content_boost=jr.max_content_boost, merge_channels=jr.write_xmp)


def api1_scans(jr, hdr, sdr, quality: int):
    """The API-1 device stages of a request on `jr.device`: (the base's and
    the gain map's [(coeffs, layout)], metadata, base sampling, map scale),
    or None when the format combination needs the general path.  For
    BEST_QUALITY this includes the read of the bounds to the host."""
    hdr_fmt, sdr_fmt = ImgFmt(hdr.fmt), ImgFmt(sdr.fmt)
    if hdr_fmt not in API1_HDR_FORMATS or sdr_fmt not in API1_SDR_FORMATS:
        return None
    hdr_cg, sdr_cg = ColorGamut(hdr.cg), ColorGamut(sdr.cg)
    ct = ColorTransfer(hdr.ct)
    scale = _resolve_scale(jr, sdr)
    use_base_cg = _use_base_cg(sdr_cg, hdr_cg, jr.write_xmp)
    one_pass = EncPreset(jr.preset) == EncPreset.REALTIME
    hdr_planes = _p010_planes(hdr) if hdr_fmt == ImgFmt.P010 \
        else hdr.planes[:1]
    sdr_planes = sdr.planes[:3] if sdr_fmt == ImgFmt.YUV420 \
        else sdr.planes[:1]
    up = upload_planes([*hdr_planes, *sdr_planes], jr.device)
    out = _api1_block_buffers(
        up[:len(hdr_planes)], up[len(hdr_planes):], hdr_fmt=hdr_fmt,
        sdr_fmt=sdr_fmt, hdr_cg=hdr_cg, sdr_cg=sdr_cg, ct=ct,
        rng=ColorRange(hdr.range), scale=scale,
        multichannel=jr.use_multi_channel_gainmap, gamma=jr.gamma,
        quality=int(quality), map_quality=jr.map_compress_quality,
        use_base_cg=use_base_cg, one_pass=one_pass)
    if one_pass:
        scans = out
        metadata = _onepass_metadata(jr, ct, use_base_cg)
    else:
        base, gains, gmin, gmax = out
        lo, hi = api1_bounds(jr, gmin, gmax)
        scans = [base, _api1_gainmap_scan(
            gains, lo, hi, jr.gamma,
            multichannel=jr.use_multi_channel_gainmap,
            map_quality=jr.map_compress_quality)]
        metadata = _twopass_metadata(jr, ct, lo, hi, use_base_cg)
    sampling = _SAMPLING_420 if sdr_fmt == ImgFmt.YUV420 else _SAMPLING_444
    return scans, metadata, sampling, scale


def encode_api1_fused(jr, hdr, sdr, quality: int, exif: bytes | None, *,
                      pack=pack_kernel.pack_scan) -> bytes | None:
    """JpegR.encode_api1 on the device: raw HDR + raw SDR in, JPEG_R out,
    both presets with one `pack` launch; None when the format combination
    needs the general path."""
    out = api1_scans(jr, hdr, sdr, quality)
    if out is None:
        return None
    scans, metadata, sampling, scale = out
    return _pack_and_assemble(jr, hdr.w, hdr.h, quality, scans, sampling,
                              ColorGamut(sdr.cg), scale, metadata, exif,
                              ColorTransfer(hdr.ct), ColorGamut(hdr.cg),
                              pack)


# ---------------------------------------------------------------------------
# decode

# chroma subsampling (h, v) of the base per sampling key
DECODE_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}


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
