"""JPEG_R codec orchestration: the five encode scenarios, fused decode.

Port of the encode scenarios API-0..4 and the fused decode of
``libultrahdr_tpu/jpegr.py`` (class JpegR, after the reference's
encodeJPEGR, jpegr.cpp:135-428, and decodeJPEGR, jpegr.cpp:1384-1446).  A
``JpegR`` carries the encoder knobs and the device it computes on: the card
(``device="cuda"``) unless the caller asks for the CPU, and a CUDA request
without a GPU raises rather than running elsewhere.

API-0 and API-1 take the fused device programs (``fused.py``) unless the
caller passes ``use_fused=False`` or the formats need the general path:
``tone_map``, ``generate_gainmap``, ``compress_gainmap`` and the raw-input
conversions on the device, each JPEG through ``jpeg.encoder.JpegEncoder``
(device DCT, host entropy coder, no restart markers).  API-2 and API-3
make their gain map on the general path; API-4 is host-only container
work.  The helpers return ``RawImage``s with host planes, as the JAX
package's do.

The decode takes the fused route only: HLG or PQ output as RGBA1010102,
LINEAR as RGBAF16, from a baseline JPEG_R whose base is 4:4:4, 4:2:2, 4:2:0
or 4:4:0 and whose gain map is 1 or 3 full-resolution channels at an integer
scale.  Everything else raises ``unsupported`` naming the ROADMAP item; it
never falls back to another path.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused
from .container import icc as icc_mod
from .container import iso21496, jpegr_container, segments, xmp
from .errors import UhdrError, UhdrErrorCode, invalid_param, unsupported
from .jpeg.decoder import (decode_to_planes, get_output_sampling_format,
                           parse_jpeg)
from .jpeg.encoder import JpegEncoder
from .ops import apply as apply_ops
from .ops import colors, gainmap as gainmap_ops, pixel
from .ops import tonemap as tonemap_ops
from .types import (ColorGamut, ColorRange, ColorTransfer, CompressedImage,
                    EncPreset, GainMapMetadata, HDR_INPUT_FORMATS, ImgFmt,
                    RGB_FORMATS, RawImage)

# Library defaults (jpegr.h:27-47)
DEFAULT_MAP_DIMENSION_SCALE_FACTOR = 1
DEFAULT_MAP_COMPRESS_QUALITY = 95
DEFAULT_USE_MULTI_CHANNEL_GAINMAP = True
DEFAULT_GAINMAP_GAMMA = 1.0
DEFAULT_ENC_PRESET = EncPreset.BEST_QUALITY
DEFAULT_TARGET_DISP_PEAK_BRIGHTNESS = -1.0

# the JpegR attributes that configure an encode
KNOBS = ("map_dimension_scale_factor", "map_compress_quality",
         "use_multi_channel_gainmap", "gamma", "preset", "min_content_boost",
         "max_content_boost", "target_disp_peak_brightness", "write_iso",
         "write_xmp")

# the largest finite float32, the default max display boost (ultrahdr_api.h)
FLT_MAX = float(np.finfo(np.float32).max)

_DECODE_OUTPUTS = (ColorTransfer.HLG, ColorTransfer.PQ, ColorTransfer.LINEAR)
_SAMPLING_KEY = {ImgFmt.YUV444: "444", ImgFmt.YUV440: "440",
                 ImgFmt.YUV422: "422", ImgFmt.YUV420: "420"}


def resolve_device(device) -> torch.device:
    """torch.device for a `device` request; a CUDA request without a usable
    GPU raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise unsupported(f"device {dev} requested but CUDA is not "
                              "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise unsupported(f"device {dev} is not supported (cpu or cuda)")
    return dev


class JpegR:
    """Codec instance carrying the encoder knobs (jpegr.cpp:135-148) and
    its compute device."""

    def __init__(self, *, device="cuda",
                 map_dimension_scale_factor: int = DEFAULT_MAP_DIMENSION_SCALE_FACTOR,
                 map_compress_quality: int = DEFAULT_MAP_COMPRESS_QUALITY,
                 use_multi_channel_gainmap: bool = DEFAULT_USE_MULTI_CHANNEL_GAINMAP,
                 gamma: float = DEFAULT_GAINMAP_GAMMA,
                 preset: EncPreset = DEFAULT_ENC_PRESET,
                 min_content_boost: float | None = None,
                 max_content_boost: float | None = None,
                 target_disp_peak_brightness: float = DEFAULT_TARGET_DISP_PEAK_BRIGHTNESS,
                 write_iso: bool | None = None, write_xmp: bool | None = None):
        self.device = resolve_device(device)
        self.map_dimension_scale_factor = int(map_dimension_scale_factor)
        self.map_compress_quality = int(map_compress_quality)
        self.use_multi_channel_gainmap = bool(use_multi_channel_gainmap)
        self.gamma = float(gamma)
        self.preset = EncPreset(preset)
        self.min_content_boost = min_content_boost
        self.max_content_boost = max_content_boost
        self.target_disp_peak_brightness = float(target_disp_peak_brightness)
        self.write_iso = jpegr_container.WRITE_ISO_METADATA \
            if write_iso is None else bool(write_iso)
        self.write_xmp = jpegr_container.WRITE_XMP_METADATA \
            if write_xmp is None else bool(write_xmp)

    @classmethod
    def from_reference_knobs(cls, d: dict, *, device="cuda") -> "JpegR":
        """A JpegR configured like a JAX-package JpegR whose knob
        attributes (KNOBS) are given as plain Python numbers in `d`."""
        missing = [k for k in KNOBS if k not in d]
        if missing:
            raise invalid_param(f"missing knobs {missing}")
        return cls(device=device, **{k: d[k] for k in KNOBS})

    # ------------------------------------------------------------------
    # tone mapping (jpegr.cpp:1853-2090)

    def tone_map(self, hdr: RawImage) -> RawImage:
        """The SDR rendition of an HDR intent (Display-P3, sRGB, full
        range): YUV420 for P010, YUV444 for YUV444_10, else RGBA8888."""
        fmt = ImgFmt(hdr.fmt)
        if fmt not in HDR_INPUT_FORMATS:
            raise unsupported(
                f"tonemap expects an hdr intent format, got {fmt}")
        hdr_vals = pixel.unpack(hdr, self.device)
        cg, ct = ColorGamut(hdr.cg), ColorTransfer(hdr.ct)
        if fmt in (ImgFmt.P010, ImgFmt.YUV444_10):
            planes = tonemap_ops.tonemap_to_yuv(
                hdr_vals, fmt, cg, ct, out_yuv420=fmt == ImgFmt.P010)
            sdr_fmt = ImgFmt.YUV420 if fmt == ImgFmt.P010 else ImgFmt.YUV444
            planes = [p.cpu().numpy() for p in planes]
        else:  # RGBA1010102 / RGBAF16
            sdr_fmt = ImgFmt.RGBA8888
            planes = [tonemap_ops.tonemap_to_rgba8888(
                hdr_vals, fmt, cg, ct).cpu().numpy().view(np.uint32)]
        return RawImage(sdr_fmt, ColorGamut.DISPLAY_P3, ColorTransfer.SRGB,
                        ColorRange.FULL, hdr.w, hdr.h, planes)

    # ------------------------------------------------------------------
    # gain map generation (jpegr.cpp:524-1051)

    def generate_gainmap(self, sdr: RawImage, hdr: RawImage,
                         sdr_is_601: bool = False,
                         use_luminance: bool = True):
        """(gain map RawImage, GainMapMetadata) of the preset: REALTIME the
        one-pass map, BEST_QUALITY the two-pass one with its bounds
        resolved on the host.  An unusable map scale is replaced and
        written back into the knob, as the reference does."""
        sdr_fmt, hdr_fmt = ImgFmt(sdr.fmt), ImgFmt(hdr.fmt)
        if sdr_fmt not in (ImgFmt.YUV444, ImgFmt.YUV422, ImgFmt.YUV420,
                           ImgFmt.RGBA8888):
            raise unsupported(f"generate gainmap: bad sdr format {sdr_fmt}")
        if hdr_fmt not in HDR_INPUT_FORMATS:
            raise unsupported(f"generate gainmap: bad hdr format {hdr_fmt}")
        hdr_ct = ColorTransfer(hdr.ct)
        if colors.reference_display_peak_nits(hdr_ct) < 0:
            raise unsupported(f"invalid hdr transfer {hdr_ct}")
        sdr_cg, hdr_cg = ColorGamut(sdr.cg), ColorGamut(hdr.cg)
        use_base_cg = fused._use_base_cg(sdr_cg, hdr_cg, self.write_xmp)
        scale = fused._resolve_scale(self, sdr)
        sdr_vals = pixel.unpack(sdr, self.device)
        hdr_vals = pixel.unpack(hdr, self.device)
        common = dict(sdr_fmt=sdr_fmt, hdr_fmt=hdr_fmt, sdr_cg=sdr_cg,
                      hdr_cg=hdr_cg, ct=hdr_ct, scale=scale,
                      multichannel=self.use_multi_channel_gainmap,
                      use_luminance=use_luminance, sdr_is_601=sdr_is_601,
                      use_base_cg=use_base_cg)
        if self.preset == EncPreset.REALTIME:
            max_boost = (colors.reference_display_peak_nits(hdr_ct)
                         / colors.SDR_WHITE_NITS)
            gm = gainmap_ops.generate_gainmap_onepass(
                sdr_vals, hdr_vals, gamma=self.gamma, max_boost=max_boost,
                **common)
            metadata = fused._onepass_metadata(self, hdr_ct, use_base_cg)
        else:
            gains, gmin, gmax = gainmap_ops.gainmap_float_pass(
                sdr_vals, hdr_vals, **common)
            lo, hi = fused.api1_bounds(self, gmin, gmax)
            gm = gainmap_ops.encode_gainmap_twopass(gains, lo, hi,
                                                    self.gamma)
            metadata = fused._twopass_metadata(self, hdr_ct, lo, hi,
                                               use_base_cg)
        gm_np = gm.cpu().numpy()
        rng = ColorRange(hdr.range)
        if self.use_multi_channel_gainmap:
            rgb = np.ascontiguousarray(np.moveaxis(gm_np, 0, -1))
            gm_img = RawImage(ImgFmt.RGB888, hdr_cg, hdr_ct, rng,
                              rgb.shape[1], rgb.shape[0], [rgb])
        else:
            gm_img = RawImage(ImgFmt.YUV400, hdr_cg, hdr_ct, rng,
                              gm_np.shape[2], gm_np.shape[1], [gm_np[0]])
        return gm_img, metadata

    def compress_gainmap(self, gm_img: RawImage) -> bytes:
        """compressGainMap (jpegr.cpp:514-522): ICC only in ISO mode."""
        icc = None
        if not self.write_xmp:
            icc = icc_mod.write_icc_profile(gm_img.ct, gm_img.cg)
        return JpegEncoder(self.device).compress(
            gm_img, self.map_compress_quality, icc=icc, gainmap_comment=True)

    # ------------------------------------------------------------------
    # raw input conversions

    def convert_raw_to_ycbcr(self, img: RawImage,
                             chroma_sampling: bool = False) -> RawImage:
        """convert_raw_input_to_ycbcr (gainmapmath.cpp:1291-1501): RGBA8888
        to YUV444 (YUV420 with `chroma_sampling`), RGBA1010102 to
        YUV444_10 (P010); YUV420 and P010 are copied."""
        fmt = ImgFmt(img.fmt)
        if fmt in (ImgFmt.YUV420, ImgFmt.P010):
            return img.copy()
        if fmt not in (ImgFmt.RGBA8888, ImgFmt.RGBA1010102):
            raise unsupported(f"no ycbcr conversion for format {fmt}")
        yuv = colors.apply_3x3(colors.rgb2yuv_matrix_for_gamut(img.cg),
                               pixel.unpack(img, self.device))
        eight = fmt == ImgFmt.RGBA8888
        top, dtype = (255.0, torch.uint8) if eight else (1023.0, torch.int32)
        y = torch.clamp(yuv[0] * top + 0.5, 0, top).to(dtype)
        if chroma_sampling:
            h2, w2 = (img.h // 2) * 2, (img.w // 2) * 2
            # chroma averaged pre-bias over the 2x2 quad
            u, v = (c[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)
                    .mean(dim=(1, 3)) for c in yuv[1:])
        else:
            u, v = yuv[1], yuv[2]
        if eight:
            u, v = (torch.clamp(c * 255.0 + 0.5 + 128.0, 0, 255)
                    .to(torch.uint8).cpu().numpy() for c in (u, v))
            return RawImage(ImgFmt.YUV420 if chroma_sampling
                            else ImgFmt.YUV444, img.cg, img.ct,
                            ColorRange.FULL, img.w, img.h,
                            [y.cpu().numpy(), u, v])
        y10, u10, v10 = (p.cpu().numpy().astype(np.uint16) for p in (
            y, *(torch.clamp(c * 1023.0 + 512.5, 0, 1023).to(torch.int32)
                 for c in (u, v))))
        if chroma_sampling:
            uv = np.empty((h2 // 2, w2), np.uint16)
            uv[:, 0::2] = u10 << 6
            uv[:, 1::2] = v10 << 6
            return RawImage(ImgFmt.P010, img.cg, img.ct, ColorRange.FULL,
                            img.w, img.h, [(y10 << 6).astype(np.uint16), uv])
        return RawImage(ImgFmt.YUV444_10, img.cg, img.ct, ColorRange.FULL,
                        img.w, img.h, [y10, u10, v10])

    def convert_yuv_encoding(self, img: RawImage, src_cg,
                             dst_cg) -> RawImage:
        """convertYuv / transformYuv420/444 (jpegr.cpp:430-513,
        gainmapmath.cpp:686-748): the YUV encoding of `src_cg` re-encoded
        as `dst_cg`'s (the image itself when they match)."""
        if colors.yuv_encoding_conversion_matrix(src_cg, dst_cg) is None:
            return img
        fmt = ImgFmt(img.fmt)
        if fmt not in (ImgFmt.YUV420, ImgFmt.YUV444):
            raise unsupported(f"no yuv gamut conversion for format {fmt}")
        planes = fused._convert_yuv_encoding_planes(
            [pixel.plane_tensor(p, self.device) for p in img.planes[:3]],
            fmt, ColorGamut(src_cg), ColorGamut(dst_cg), img.h, img.w)
        return RawImage(fmt, dst_cg, img.ct, img.range, img.w, img.h,
                        [p.cpu().numpy() for p in planes])

    def _jpegr_from_raw(self, sdr: RawImage, gm_jpeg: bytes,
                        metadata: GainMapMetadata, quality: int,
                        exif: bytes | None, to_p3: bool) -> bytes:
        """The general path's base JPEG and container: an RGB SDR through
        its YCbCr, re-encoded as BT.601 YUV when `to_p3`
        (jpegr.cpp:268-273)."""
        icc = icc_mod.write_icc_profile(ColorTransfer.SRGB, sdr.cg)
        sdr_yuv = self.convert_raw_to_ycbcr(sdr) \
            if ImgFmt(sdr.fmt) in RGB_FORMATS else sdr
        if to_p3:
            sdr_yuv = self.convert_yuv_encoding(sdr_yuv, sdr_yuv.cg,
                                                ColorGamut.DISPLAY_P3)
        sdr_jpeg = JpegEncoder(self.device).compress(sdr_yuv, quality,
                                                     icc=icc)
        return jpegr_container.append_gainmap(
            sdr_jpeg, gm_jpeg, metadata, exif=exif, icc=None,
            write_iso=self.write_iso, write_xmp=self.write_xmp)

    # ------------------------------------------------------------------
    # encode scenarios

    def encode_api0(self, hdr: RawImage, quality: int = 95,
                    exif: bytes | None = None,
                    use_fused: bool = True) -> bytes:
        """encodeJPEGR API-0 (jpegr.cpp:173-200): HDR intent (P010,
        RGBA1010102, RGBAF16 or YUV444_10) in, JPEG_R out, with the SDR base
        tone-mapped and a one-pass gain map.  `use_fused=False` takes the
        general path (tone_map, REALTIME generate_gainmap,
        compress_gainmap, JpegEncoder)."""
        fmt = ImgFmt(hdr.fmt)
        if fmt not in HDR_INPUT_FORMATS:
            raise invalid_param(f"unsupported hdr intent color format {fmt}")
        if use_fused:
            if fmt == ImgFmt.P010:
                return fused.encode_api0_p010_fused(self, hdr, quality, exif)
            if fmt in (ImgFmt.RGBA1010102, ImgFmt.RGBAF16):
                return fused.encode_api0_rgb_fused(self, hdr, quality, exif)
            return fused.encode_api0_yuv444_10_fused(self, hdr, quality,
                                                     exif)
        sdr = self.tone_map(hdr)
        # a tone-mapped intent needs only the one-pass map (jpegr.cpp:200)
        saved_preset = self.preset
        self.preset = EncPreset.REALTIME
        try:
            gm_img, metadata = self.generate_gainmap(
                sdr, hdr, sdr_is_601=False, use_luminance=False)
        finally:
            self.preset = saved_preset
        return self._jpegr_from_raw(sdr, self.compress_gainmap(gm_img),
                                    metadata, quality, exif, to_p3=False)

    def encode_api1(self, hdr: RawImage, sdr: RawImage, quality: int = 95,
                    exif: bytes | None = None,
                    use_fused: bool = True) -> bytes:
        """encodeJPEGR API-1 (jpegr.cpp:236-295): raw HDR + raw SDR in; the
        fused device program for P010/RGBA1010102/RGBAF16 HDR with
        YUV420/RGBA8888 SDR, else (or with `use_fused=False`) the general
        path."""
        self._check_dims_match(hdr, sdr)
        if use_fused:
            out = fused.encode_api1_fused(self, hdr, sdr, quality, exif)
            if out is not None:
                return out
        gm_img, metadata = self.generate_gainmap(
            sdr, hdr, sdr_is_601=False, use_luminance=True)
        return self._jpegr_from_raw(sdr, self.compress_gainmap(gm_img),
                                    metadata, quality, exif, to_p3=True)

    def encode_api2(self, hdr: RawImage, sdr: RawImage,
                    sdr_compressed: CompressedImage) -> bytes:
        """encodeJPEGR API-2 (jpegr.cpp:297-346): raw HDR + raw SDR +
        compressed SDR; the compressed SDR is the base as given."""
        info = parse_jpeg(sdr_compressed.data)
        if hdr.w != info.width or hdr.h != info.height:
            raise invalid_param(
                f"hdr intent {hdr.w}x{hdr.h} vs compressed sdr "
                f"{info.width}x{info.height} mismatch")
        gm_img, metadata = self.generate_gainmap(
            sdr, hdr, sdr_is_601=False, use_luminance=True)
        return self.encode_api4(
            CompressedImage(sdr_compressed.data, sdr_compressed.cg),
            CompressedImage(self.compress_gainmap(gm_img)), metadata)

    def encode_api3(self, hdr: RawImage,
                    sdr_compressed: CompressedImage) -> bytes:
        """encodeJPEGR API-3 (jpegr.cpp:348-398): raw HDR + compressed SDR;
        the SDR planes are decoded on the device (baseline only), its gamut
        read from its ICC profile or else taken from the caller."""
        info = parse_jpeg(sdr_compressed.data)
        planes, fmt = decode_to_planes(sdr_compressed.data, info,
                                       self.device)
        if info.icc:
            cg = icc_mod.read_icc_color_gamut(info.icc)
            if cg == ColorGamut.UNSPECIFIED or (
                    sdr_compressed.cg != ColorGamut.UNSPECIFIED
                    and sdr_compressed.cg != cg):
                raise invalid_param(f"configured gamut {sdr_compressed.cg} "
                                    f"does not match icc {cg}")
        else:
            if ColorGamut(sdr_compressed.cg) == ColorGamut.UNSPECIFIED:
                raise invalid_param("unrecognized 420 color gamut")
            cg = ColorGamut(sdr_compressed.cg)
        sdr = RawImage(fmt, cg, ColorTransfer.SRGB, ColorRange.FULL,
                       info.width, info.height, planes)
        self._check_dims_match(hdr, sdr)
        gm_img, metadata = self.generate_gainmap(
            sdr, hdr, sdr_is_601=True, use_luminance=True)
        return self.encode_api4(
            CompressedImage(sdr_compressed.data, cg),
            CompressedImage(self.compress_gainmap(gm_img)), metadata)

    def encode_api4(self, base: CompressedImage, gainmap: CompressedImage,
                    metadata: GainMapMetadata) -> bytes:
        """encodeJPEGR API-4 (jpegr.cpp:400-428): compressed base +
        compressed gain map + metadata, host only.  EXIF moves from the base
        stream to the container level; an ICC profile is written when the
        base carries none."""
        base_info = parse_jpeg(base.data)
        if not metadata.use_base_cg:
            gm_info = parse_jpeg(gainmap.data)
            if not gm_info.icc:
                raise unsupported(
                    "gainmap application space is alternate image space but "
                    "the gainmap jpeg carries no ICC")
        icc = None
        if not base_info.icc:
            if ColorGamut(base.cg) == ColorGamut.UNSPECIFIED:
                raise invalid_param("unrecognized 420 color gamut")
            icc = icc_mod.write_icc_profile(ColorTransfer.SRGB, base.cg)
        exif = None
        base_data = base.data
        if base_info.exif is not None:
            # the APP1 segment (marker, length, payload) leaves the stream
            exif = base_info.exif
            start = base_info.exif_offset - 4
            seglen = 2 + len(base_info.exif)
            base_data = base_data[:start] + base_data[start + 2 + seglen:]
        return jpegr_container.append_gainmap(
            base_data, gainmap.data, metadata, exif=exif, icc=icc,
            write_iso=self.write_iso, write_xmp=self.write_xmp)

    @staticmethod
    def _check_dims_match(hdr: RawImage, sdr: RawImage):
        if hdr.w != sdr.w or hdr.h != sdr.h:
            raise invalid_param(
                f"sdr intent {sdr.w}x{sdr.h} and hdr intent {hdr.w}x{hdr.h} "
                "resolutions do not match")

    # ------------------------------------------------------------------
    # decode

    @staticmethod
    def extract_primary_and_gainmap(data: bytes):
        ranges = segments.scan_jpeg_images(data, limit=2)
        primary = data[ranges[0][0]:ranges[0][1]]
        gm = data[ranges[1][0]:ranges[1][1]] if len(ranges) > 1 else None
        return primary, gm

    def get_info(self, data: bytes) -> dict:
        """getJPEGRInfo (jpegr.cpp:1332-1345): dims + marker blobs per image."""
        primary, gm = self.extract_primary_and_gainmap(data)
        pinfo = parse_jpeg(primary, parse_only=True)
        out = {"width": pinfo.width, "height": pinfo.height,
               "primary": pinfo, "gainmap": None}
        if gm is not None:
            out["gainmap"] = parse_jpeg(gm, parse_only=True)
        return out

    def parse_gainmap_metadata(self, iso: bytes | None, xmp_blob: bytes | None,
                               exif: bytes | None) -> GainMapMetadata:
        """parseGainMapMetadata (jpegr.cpp:1347-1381): ISO preferred."""
        if iso:
            ns = b"urn:iso:std:iso:ts:21496:-1\x00"
            if len(iso) < len(ns):
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "iso block too small")
            if not iso.startswith(ns):
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "iso block namespace mismatch")
            frac = iso21496.decode_gainmap_metadata(iso[len(ns):])
            return iso21496.fraction_to_float(frac)
        if xmp_blob:
            return xmp.parse_xmp_metadata(xmp_blob, exif)
        raise invalid_param("received no valid buffer to parse gainmap metadata")

    def _parse_jpegr(self, data: bytes, output_ct: ColorTransfer):
        """Split and parse a JPEG_R file for an HDR output:
        (primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg)."""
        if output_ct not in _DECODE_OUTPUTS:
            raise unsupported(
                f"decode to {output_ct.name} is not ported yet (ROADMAP.md, "
                "decode side: SRGB/RGBA8888 output)")
        primary, gm_jpeg = self.extract_primary_and_gainmap(data)
        pinfo = parse_jpeg(primary)
        if gm_jpeg is None:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "no gain map image present")
        gm_info = parse_jpeg(gm_jpeg)
        metadata = self.parse_gainmap_metadata(gm_info.iso, gm_info.xmp,
                                               pinfo.exif)
        sdr_cg = icc_mod.read_icc_color_gamut(pinfo.icc) if pinfo.icc \
            else ColorGamut.UNSPECIFIED
        gm_cg = icc_mod.read_icc_color_gamut(gm_info.icc) if gm_info.icc \
            else ColorGamut.UNSPECIFIED
        return primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg

    def decode(self, data: bytes, output_ct=ColorTransfer.HLG,
               output_fmt=ImgFmt.RGBA1010102,
               max_display_boost: float = FLT_MAX,
               return_gainmap: bool = False, use_fused: bool = True):
        """decodeJPEGR (jpegr.cpp:1384-1446) on the fused route.

        Returns (RawImage dest, GainMapMetadata, gainmap RawImage | None).
        The output format follows the transfer (HLG/PQ: RGBA1010102,
        LINEAR: RGBAF16), as on the JAX package's fused route; `output_fmt`
        is accepted for the same signature and not read."""
        del output_fmt
        if not use_fused:
            raise unsupported(
                "the general decode path is not ported yet (ROADMAP.md, "
                "decode side: the general path)")
        output_ct = ColorTransfer(output_ct)
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data, output_ct)
        dest, gainmap_img = self._try_decode_fused(
            primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
            max_display_boost, sdr_cg, gm_cg)
        return dest, metadata, gainmap_img if return_gainmap else None

    def _try_decode_fused(self, primary, pinfo, gm_jpeg, gm_info, metadata,
                          output_ct, max_display_boost, sdr_cg, gm_cg):
        """The fused decode with a raw download: (dest RawImage, gainmap
        RawImage) in host memory."""
        packed_dev, gm_dev, h_cg = self._decode_fused_device(
            primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
            max_display_boost, sdr_cg, gm_cg)
        w, h = pinfo.width, pinfo.height
        mw, mh = gm_info.width, gm_info.height
        # a 3-channel map is interleaved to (mh, mw, 3) on the device: the
        # host transpose of a full-resolution map cost tens of ms
        gm_u8 = gm_dev.permute(1, 2, 0).contiguous().cpu().numpy()
        if output_ct == ColorTransfer.LINEAR:
            dest = RawImage(ImgFmt.RGBAF16, h_cg, output_ct, ColorRange.FULL,
                            w, h, [packed_dev.cpu().numpy().view(np.uint16)])
        else:
            dest = RawImage(ImgFmt.RGBA1010102, h_cg, output_ct,
                            ColorRange.FULL, w, h,
                            [packed_dev.cpu().numpy().view(np.uint32)])
        if gm_info.num_components == 1:
            gm_img = RawImage(ImgFmt.YUV400, ColorGamut(gm_cg),
                              ColorTransfer.UNSPECIFIED, ColorRange.FULL,
                              mw, mh, [gm_u8[..., 0]])
        else:
            gm_img = RawImage(ImgFmt.RGB888, ColorGamut(gm_cg),
                              ColorTransfer.UNSPECIFIED, ColorRange.FULL,
                              mw, mh, [gm_u8])
        return dest, gm_img

    def _decode_fused_device(self, primary, pinfo, gm_jpeg, gm_info,
                             metadata, output_ct, max_display_boost, sdr_cg,
                             gm_cg):
        """Device half of the fused decode on ``self.device``; returns
        (packed output, gain map u8, hdr gamut) with the tensors left on the
        device.  Raises ``unsupported`` for a stream the fused route does
        not take."""
        if pinfo.progressive or gm_info.progressive:
            raise unsupported(
                "progressive JPEG_R streams are not ported yet (ROADMAP.md, "
                "decode side: the general path)")
        if pinfo.num_components != 3 or gm_info.num_components not in (1, 3):
            raise unsupported(
                f"component counts {pinfo.num_components}/"
                f"{gm_info.num_components} need the general path, not "
                "ported yet (ROADMAP.md, decode side)")
        key = _SAMPLING_KEY.get(get_output_sampling_format(pinfo))
        if key is None or (gm_info.num_components == 3 and any(
                c.h != 1 or c.v != 1 for c in gm_info.components)):
            raise unsupported(
                "this chroma sampling needs the general decode path, not "
                "ported yet (ROADMAP.md, decode side: the general path)")
        w, h = pinfo.width, pinfo.height
        mw, mh = gm_info.width, gm_info.height
        if mw == 0 or mh == 0 or w % mw or h % mh or w // mw != h // mh:
            raise unsupported(
                f"a {mw}x{mh} gain map on a {w}x{h} image needs the "
                "fractional-scale or resize decode path, not ported yet "
                "(ROADMAP.md, decode side: the general path)")

        s_cg = ColorGamut(sdr_cg)
        if s_cg == ColorGamut.UNSPECIFIED:
            s_cg = ColorGamut.BT709
        h_cg = ColorGamut(gm_cg)
        if h_cg == ColorGamut.UNSPECIFIED:
            h_cg = s_cg

        base_coeffs, base_qts, _ = fused.decode_coefficients(primary, pinfo)
        gm_coeffs, gm_qts, _ = fused.decode_coefficients(gm_jpeg, gm_info)
        weight = apply_ops.gainmap_weight(
            max_display_boost, float(metadata.hdr_capacity_min),
            float(metadata.hdr_capacity_max))
        packed, gm_u8 = fused._decode_device_core(
            fused.upload_coeff_planes(base_coeffs, self.device), base_qts,
            fused.upload_coeff_planes(gm_coeffs, self.device), gm_qts,
            apply_ops.metadata_to_arrays(metadata), np.float32(weight),
            h=h, w=w, sampling_key=key, gm_channels=gm_info.num_components,
            scale_k=w // mw, out_ct=output_ct, sdr_cg=s_cg, hdr_cg=h_cg,
            use_base_cg=bool(metadata.use_base_cg))
        return packed, gm_u8, h_cg

    def decode_to_device(self, data: bytes, output_ct=ColorTransfer.HLG,
                         max_display_boost: float = FLT_MAX):
        """Decode with the result left on ``self.device``: (packed output
        tensor, GainMapMetadata), the output (H, W) int32 RGBA1010102
        patterns or (H, W, 4) int16 RGBAF16 patterns (ops/pixel.py).  The
        per-image route (the JAX _decode_to_device_one); the microbatcher,
        the batch route and effects are not ported yet (ROADMAP.md)."""
        output_ct = ColorTransfer(output_ct)
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data, output_ct)
        packed, _, _ = self._decode_fused_device(
            primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
            max_display_boost, sdr_cg, gm_cg)
        return packed, metadata
