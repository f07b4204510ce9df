"""JPEG_R codec orchestration: encode API-0 for P010 input, fused decode.

Port of the encode-API-0 part and the fused decode of
``libultrahdr_tpu/jpegr.py`` (class JpegR, after the reference's
jpegr.cpp:135-200 and decodeJPEGR, jpegr.cpp:1384-1446).  A ``JpegR``
carries the encoder knobs and the device it computes on; the device is an
explicit argument, never looked up, and a CUDA request without a GPU raises.

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
from .fused import encode_api0_p010_fused
from .jpeg.decoder import get_output_sampling_format, parse_jpeg
from .ops import apply as apply_ops
from .types import (ColorGamut, ColorRange, ColorTransfer, EncPreset,
                    GainMapMetadata, HDR_INPUT_FORMATS, ImgFmt, RawImage)

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
    """torch.device for an explicit `device` request; a CUDA request
    without a usable GPU raises instead of running elsewhere."""
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

    def __init__(self, *, device,
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
    def from_reference_knobs(cls, d: dict, *, device) -> "JpegR":
        """A JpegR configured like a JAX-package JpegR whose knob
        attributes (KNOBS) are given as plain Python numbers in `d`."""
        missing = [k for k in KNOBS if k not in d]
        if missing:
            raise invalid_param(f"missing knobs {missing}")
        return cls(device=device, **{k: d[k] for k in KNOBS})

    def encode_api0(self, hdr: RawImage, quality: int = 95,
                    exif: bytes | None = None) -> bytes:
        """encodeJPEGR API-0 (jpegr.cpp:173-200): HDR intent in, JPEG_R out,
        with the SDR base tone-mapped and a one-pass gain map."""
        fmt = ImgFmt(hdr.fmt)
        if fmt not in HDR_INPUT_FORMATS:
            raise invalid_param(f"unsupported hdr intent color format {fmt}")
        if fmt != ImgFmt.P010:
            raise unsupported(
                f"API-0 encode of {fmt.name} is not ported yet "
                "(ROADMAP.md, Queue 1: the other encode formats and APIs)")
        return encode_api0_p010_fused(self, hdr, quality, exif)

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
