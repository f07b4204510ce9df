"""Deprecated pre-1.0 JPEGR API surface (compat shim).

Port of ``libultrahdr_tpu/jpegr_compat.py``, kept as it is on top of the
port's :class:`libultrahdr_tpu_torch.jpegr.JpegR`, on the card unless the
caller asks for the CPU (``JpegRCompat(device="cpu")``; a CUDA request
without a GPU raises).  It mirrors the reference's legacy `ultrahdr.h`
structs and enums and the `JpegR::encodeJPEGR` / `decodeJPEGR` /
`getJPEGRInfo` legacy overloads (lib/include/ultrahdr/ultrahdr.h:27-186,
lib/src/jpegr.cpp:2092-2758), which in the reference are thin adapters
that translate the old struct layout into the stable v1.x API and collapse
all post-validation errors to JPEGR_UNKNOWN_ERROR: status-int returns,
caller-provided dest buffers with ``maxLength`` semantics, flat
single-buffer raw images with pixel strides, and the legacy output-format
enum.

The reference guarantees legacy-vs-new bit-identity
(tests/jpegr_test.cpp:1537-1558); here both surfaces call the same
implementation, so the guarantee is structural.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np

from .errors import UhdrError
from .jpegr import JpegR
from .types import (ColorGamut, ColorRange, ColorTransfer, CompressedImage,
                    EncPreset, GainMapMetadata, ImgFmt, RawImage,
                    UHDR_MAX_DIMENSION, MIN_WIDTH, MIN_HEIGHT)

__all__ = [
    "Status", "UltrahdrColorGamut", "UltrahdrTransferFunction",
    "UltrahdrOutputFormat", "JpegRUncompressed", "JpegRCompressed",
    "JpegRExif", "UltrahdrMetadata", "JpegInfo", "JpegRInfo",
    "JpegRCompat",
]


class Status(enum.IntEnum):
    """status_t (ultrahdr.h:27-60)."""

    JPEGR_NO_ERROR = 0
    JPEGR_UNKNOWN_ERROR = -1

    ERROR_JPEGR_BAD_PTR = -10001
    ERROR_JPEGR_UNSUPPORTED_WIDTH_HEIGHT = -10002
    ERROR_JPEGR_INVALID_COLORGAMUT = -10003
    ERROR_JPEGR_INVALID_STRIDE = -10004
    ERROR_JPEGR_INVALID_TRANS_FUNC = -10005
    ERROR_JPEGR_RESOLUTION_MISMATCH = -10006
    ERROR_JPEGR_INVALID_QUALITY_FACTOR = -10007
    ERROR_JPEGR_INVALID_DISPLAY_BOOST = -10008
    ERROR_JPEGR_INVALID_OUTPUT_FORMAT = -10009
    ERROR_JPEGR_BAD_METADATA = -10010
    ERROR_JPEGR_INVALID_CROPPING_PARAMETERS = -10011
    ERROR_JPEGR_INVALID_GAMMA = -10012
    ERROR_JPEGR_INVALID_ENC_PRESET = -10013
    ERROR_JPEGR_INVALID_TARGET_DISP_PEAK_BRIGHTNESS = -10014

    ERROR_JPEGR_ENCODE_ERROR = -20001
    ERROR_JPEGR_DECODE_ERROR = -20002
    ERROR_JPEGR_GAIN_MAP_IMAGE_NOT_FOUND = -20003
    ERROR_JPEGR_BUFFER_TOO_SMALL = -20004
    ERROR_JPEGR_METADATA_ERROR = -20005
    ERROR_JPEGR_NO_IMAGES_FOUND = -20006
    ERROR_JPEGR_MULTIPLE_EXIFS_RECEIVED = -20007
    ERROR_JPEGR_UNSUPPORTED_MAP_SCALE_FACTOR = -20008
    ERROR_JPEGR_GAIN_MAP_SIZE_ERROR = -20009

    ERROR_JPEGR_UNSUPPORTED_FEATURE = -30000


class UltrahdrColorGamut(enum.IntEnum):
    """ultrahdr_color_gamut (ultrahdr.h:63-69)."""

    UNSPECIFIED = -1
    BT709 = 0
    P3 = 1
    BT2100 = 2


class UltrahdrTransferFunction(enum.IntEnum):
    """ultrahdr_transfer_function (ultrahdr.h:73-80)."""

    UNSPECIFIED = -1
    LINEAR = 0
    HLG = 1
    PQ = 2
    SRGB = 3


class UltrahdrOutputFormat(enum.IntEnum):
    """ultrahdr_output_format (ultrahdr.h:83-90)."""

    UNSPECIFIED = -1
    SDR = 0         # RGBA_8888
    HDR_LINEAR = 1  # RGBA F16 linear
    HDR_PQ = 2      # RGBA_1010102 PQ
    HDR_HLG = 3     # RGBA_1010102 HLG


# legacy gamut <-> v1.x gamut (jpegr.cpp map_legacy_cg_to_cg)
_CG_FROM_LEGACY = {
    UltrahdrColorGamut.BT709: ColorGamut.BT709,
    UltrahdrColorGamut.P3: ColorGamut.DISPLAY_P3,
    UltrahdrColorGamut.BT2100: ColorGamut.BT2100,
    UltrahdrColorGamut.UNSPECIFIED: ColorGamut.UNSPECIFIED,
}
_CG_TO_LEGACY = {v: k for k, v in _CG_FROM_LEGACY.items()}

_CT_FROM_LEGACY = {
    UltrahdrTransferFunction.LINEAR: ColorTransfer.LINEAR,
    UltrahdrTransferFunction.HLG: ColorTransfer.HLG,
    UltrahdrTransferFunction.PQ: ColorTransfer.PQ,
    UltrahdrTransferFunction.SRGB: ColorTransfer.SRGB,
    UltrahdrTransferFunction.UNSPECIFIED: ColorTransfer.UNSPECIFIED,
}


@dataclasses.dataclass
class JpegRUncompressed:
    """jpegr_uncompressed_struct (ultrahdr.h:120-152): ONE flat buffer +
    pixel strides, chroma optionally a separate buffer.

    `data` / `chroma_data` are 1-D numpy arrays (uint16 for P010,
    uint8 for YUV420) or anything buffer-protocol viewable as such."""

    data: Optional[np.ndarray] = None
    width: int = 0
    height: int = 0
    color_gamut: UltrahdrColorGamut = UltrahdrColorGamut.UNSPECIFIED
    chroma_data: Optional[np.ndarray] = None
    luma_stride: int = 0    # pixels; 0 = width
    chroma_stride: int = 0  # pixels
    pixel_format: ImgFmt = ImgFmt.UNSPECIFIED
    color_range: ColorRange = ColorRange.UNSPECIFIED


@dataclasses.dataclass
class JpegRCompressed:
    """jpegr_compressed_struct (ultrahdr.h:157-167): caller-owned buffer.

    `data` must be a pre-allocated writable bytearray/memoryview of
    `max_length` bytes for outputs; `length` is the used size."""

    data: Optional[bytearray] = None
    length: int = 0
    max_length: int = 0
    color_gamut: UltrahdrColorGamut = UltrahdrColorGamut.UNSPECIFIED


@dataclasses.dataclass
class JpegRExif:
    """jpegr_exif_struct (ultrahdr.h:172-177)."""

    data: Optional[bytearray] = None
    length: int = 0


@dataclasses.dataclass
class UltrahdrMetadata:
    """ultrahdr_metadata_struct (ultrahdr.h:98-117): scalar (not
    per-channel) gainmap metadata, linear space."""

    version: str = "1.0"
    max_content_boost: float = 1.0
    min_content_boost: float = 1.0
    gamma: float = 1.0
    offset_sdr: float = 0.0
    offset_hdr: float = 0.0
    hdr_capacity_min: float = 1.0
    hdr_capacity_max: float = 1.0


@dataclasses.dataclass
class JpegInfo:
    """jpeg_info_struct (jpegr.h:54-63)."""

    img_data: bytes = b""
    icc_data: bytes = b""
    exif_data: bytes = b""
    xmp_data: bytes = b""
    iso_data: bytes = b""
    width: int = 0
    height: int = 0
    num_components: int = 0


@dataclasses.dataclass
class JpegRInfo:
    """jpegr_info_struct (jpegr.h:68-73)."""

    width: int = 0
    height: int = 0
    primary_img_info: Optional[JpegInfo] = None
    gainmap_img_info: Optional[JpegInfo] = None


def _flat(buf, dtype):
    a = np.frombuffer(memoryview(buf).cast("B"), np.uint8) \
        if not isinstance(buf, np.ndarray) else buf
    return a.reshape(-1).view(dtype)


def _strided(buf, dtype, rows, row_pixels, stride_pixels, offset_px=0):
    """View `rows` rows of `row_pixels` from a flat buffer laid out with a
    pixel stride (the legacy struct's layout contract)."""
    flat = _flat(buf, dtype)[offset_px:]
    need = (rows - 1) * stride_pixels + row_pixels
    if flat.size < need:
        raise ValueError("legacy raw buffer too small for stride layout")
    return np.lib.stride_tricks.as_strided(
        flat, (rows, row_pixels),
        (stride_pixels * flat.itemsize, flat.itemsize)).copy()


def _p010_to_raw(img: JpegRUncompressed,
                 tf: UltrahdrTransferFunction) -> RawImage:
    """jpegr.cpp:2267-2288: default strides, chroma after luma."""
    w, h = img.width, img.height
    ls = img.luma_stride or w
    y = _strided(img.data, np.uint16, h, w, ls)
    if img.chroma_data is not None:
        uv = _strided(img.chroma_data, np.uint16, h // 2, w,
                      img.chroma_stride or ls)
    else:
        uv = _strided(img.data, np.uint16, h // 2, w, ls, offset_px=ls * h)
    rng = img.color_range if img.color_range != ColorRange.UNSPECIFIED \
        else ColorRange.LIMITED
    return RawImage(ImgFmt.P010, _CG_FROM_LEGACY[img.color_gamut],
                    _CT_FROM_LEGACY[tf], rng, w, h, [y, uv])


def _yuv420_to_raw(img: JpegRUncompressed) -> RawImage:
    """jpegr.cpp:2354-2376: U plane then V plane after luma; chroma
    stride defaults to luma_stride >> 1."""
    w, h = img.width, img.height
    ls = img.luma_stride or w
    y = _strided(img.data, np.uint8, h, w, ls)
    cs = img.chroma_stride or (ls >> 1)
    if img.chroma_data is not None:
        u = _strided(img.chroma_data, np.uint8, h // 2, w // 2, cs)
        v = _strided(img.chroma_data, np.uint8, h // 2, w // 2, cs,
                     offset_px=(h // 2) * cs)
    else:
        base = ls * h
        u = _strided(img.data, np.uint8, h // 2, w // 2, cs, offset_px=base)
        v = _strided(img.data, np.uint8, h // 2, w // 2, cs,
                     offset_px=base + (h // 2) * cs)
    rng = img.color_range if img.color_range != ColorRange.UNSPECIFIED \
        else ColorRange.FULL
    return RawImage(ImgFmt.YUV420, _CG_FROM_LEGACY[img.color_gamut],
                    ColorTransfer.SRGB, rng, w, h, [y, u, v])


def _write_out(dest: JpegRCompressed, blob: bytes,
               cg: ColorGamut = ColorGamut.UNSPECIFIED) -> Status:
    if len(blob) > dest.max_length:
        return Status.ERROR_JPEGR_BUFFER_TOO_SMALL
    memoryview(dest.data)[:len(blob)] = blob
    dest.length = len(blob)
    dest.color_gamut = _CG_TO_LEGACY.get(cg, UltrahdrColorGamut.UNSPECIFIED)
    return Status.JPEGR_NO_ERROR


class JpegRCompat:
    """Legacy JpegR facade (jpegr.h:77-110 constructor args, with the
    Android defaults: map scale 4, map quality 85, single-channel map,
    realtime preset — kMapDimensionScaleFactorAndroidDefault etc.,
    jpegr.h:28-43) on `device`."""

    def __init__(self, map_dimension_scale_factor: int = 4,
                 map_compress_quality: int = 85,
                 use_multi_channel_gainmap: bool = False,
                 gamma: float = 1.0,
                 preset: EncPreset = EncPreset.REALTIME,
                 min_content_boost: float = -float("inf"),
                 max_content_boost: float = float("inf"),
                 target_disp_peak_brightness: float = -1.0, *,
                 device="cuda"):
        finite_min = min_content_boost if math.isfinite(min_content_boost) \
            and min_content_boost > 0 else None
        finite_max = max_content_boost if math.isfinite(max_content_boost) \
            else None
        self._gamma = gamma
        self._preset = preset
        self._boosts = (min_content_boost, max_content_boost)
        self._jr = JpegR(
            device=device,
            map_dimension_scale_factor=map_dimension_scale_factor,
            map_compress_quality=map_compress_quality,
            use_multi_channel_gainmap=use_multi_channel_gainmap,
            gamma=gamma if gamma > 0 and math.isfinite(gamma) else 1.0,
            preset=preset if preset in (EncPreset.REALTIME,
                                        EncPreset.BEST_QUALITY)
            else EncPreset.REALTIME,
            min_content_boost=finite_min, max_content_boost=finite_max,
            target_disp_peak_brightness=target_disp_peak_brightness)
        self._target_nits = target_disp_peak_brightness

    # -- validation (jpegr.cpp:2092-2202) ------------------------------

    def _validate(self, p010: Optional[JpegRUncompressed],
                  yuv420: Optional[JpegRUncompressed],
                  tf: Optional[UltrahdrTransferFunction],
                  dest: Optional[JpegRCompressed],
                  quality: Optional[int] = None) -> Status:
        if p010 is None or p010.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if p010.width % 2 or p010.height % 2:
            return Status.ERROR_JPEGR_UNSUPPORTED_WIDTH_HEIGHT
        if p010.width < MIN_WIDTH or p010.height < MIN_HEIGHT:
            return Status.ERROR_JPEGR_UNSUPPORTED_WIDTH_HEIGHT
        if p010.width > UHDR_MAX_DIMENSION or p010.height > UHDR_MAX_DIMENSION:
            return Status.ERROR_JPEGR_UNSUPPORTED_WIDTH_HEIGHT
        if not (UltrahdrColorGamut.BT709 <= p010.color_gamut
                <= UltrahdrColorGamut.BT2100):
            return Status.ERROR_JPEGR_INVALID_COLORGAMUT
        if p010.luma_stride and p010.luma_stride < p010.width:
            return Status.ERROR_JPEGR_INVALID_STRIDE
        if p010.chroma_data is not None and p010.chroma_stride < p010.width:
            return Status.ERROR_JPEGR_INVALID_STRIDE
        if dest is None or dest.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if tf is not None and (
                not (UltrahdrTransferFunction.LINEAR <= tf
                     <= UltrahdrTransferFunction.SRGB)
                or tf == UltrahdrTransferFunction.SRGB):
            return Status.ERROR_JPEGR_INVALID_TRANS_FUNC
        sf = self._jr.map_dimension_scale_factor
        if sf <= 0 or sf > 128:
            return Status.ERROR_JPEGR_UNSUPPORTED_MAP_SCALE_FACTOR
        if not (0 <= self._jr.map_compress_quality <= 100):
            return Status.ERROR_JPEGR_INVALID_QUALITY_FACTOR
        if not math.isfinite(self._gamma) or self._gamma <= 0.0:
            return Status.ERROR_JPEGR_INVALID_GAMMA
        if self._preset not in (EncPreset.REALTIME, EncPreset.BEST_QUALITY):
            return Status.ERROR_JPEGR_INVALID_ENC_PRESET
        mn, mx = self._boosts
        if (math.isnan(mn) or math.isnan(mx) or mx < mn
                or (math.isfinite(mn) and mn <= 0.0)):
            return Status.ERROR_JPEGR_INVALID_DISPLAY_BOOST
        nits = self._target_nits
        if nits != -1.0 and not (203.0 <= nits <= 10000.0):
            return Status.ERROR_JPEGR_INVALID_TARGET_DISP_PEAK_BRIGHTNESS
        if quality is not None and not (0 <= quality <= 100):
            return Status.ERROR_JPEGR_INVALID_QUALITY_FACTOR
        if yuv420 is None:
            return Status.JPEGR_NO_ERROR
        if yuv420.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if yuv420.luma_stride and yuv420.luma_stride < yuv420.width:
            return Status.ERROR_JPEGR_INVALID_STRIDE
        if yuv420.chroma_data is not None and \
                yuv420.chroma_stride < yuv420.width // 2:
            return Status.ERROR_JPEGR_INVALID_STRIDE
        if p010.width != yuv420.width or p010.height != yuv420.height:
            return Status.ERROR_JPEGR_RESOLUTION_MISMATCH
        if not (UltrahdrColorGamut.BT709 <= yuv420.color_gamut
                <= UltrahdrColorGamut.BT2100):
            return Status.ERROR_JPEGR_INVALID_COLORGAMUT
        return Status.JPEGR_NO_ERROR

    # -- encode (jpegr.cpp:2256-2604) -----------------------------------

    def encode_api0(self, p010: JpegRUncompressed,
                    hdr_tf: UltrahdrTransferFunction,
                    dest: JpegRCompressed, quality: int = 95,
                    exif: Optional[JpegRExif] = None) -> Status:
        st = self._validate(p010, None, hdr_tf, dest, quality)
        if st != Status.JPEGR_NO_ERROR:
            return st
        if exif is not None and exif.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        try:
            blob = self._jr.encode_api0(
                _p010_to_raw(p010, hdr_tf), quality=quality,
                exif=bytes(exif.data[:exif.length]) if exif else None)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        return _write_out(dest, blob, ColorGamut.DISPLAY_P3)

    def encode_api1(self, p010: JpegRUncompressed,
                    yuv420: JpegRUncompressed,
                    hdr_tf: UltrahdrTransferFunction,
                    dest: JpegRCompressed, quality: int = 95,
                    exif: Optional[JpegRExif] = None) -> Status:
        if yuv420 is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if exif is not None and exif.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        st = self._validate(p010, yuv420, hdr_tf, dest, quality)
        if st != Status.JPEGR_NO_ERROR:
            return st
        try:
            sdr = _yuv420_to_raw(yuv420)
            blob = self._jr.encode_api1(
                _p010_to_raw(p010, hdr_tf), sdr, quality=quality,
                exif=bytes(exif.data[:exif.length]) if exif else None)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        return _write_out(dest, blob, sdr.cg)

    def encode_api2(self, p010: JpegRUncompressed,
                    yuv420: JpegRUncompressed,
                    yuv420_jpeg: JpegRCompressed,
                    hdr_tf: UltrahdrTransferFunction,
                    dest: JpegRCompressed) -> Status:
        if yuv420 is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if yuv420_jpeg is None or yuv420_jpeg.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        st = self._validate(p010, yuv420, hdr_tf, dest)
        if st != Status.JPEGR_NO_ERROR:
            return st
        try:
            sdr = _yuv420_to_raw(yuv420)
            blob = self._jr.encode_api2(
                _p010_to_raw(p010, hdr_tf), sdr,
                CompressedImage(bytes(yuv420_jpeg.data[:yuv420_jpeg.length]),
                                _CG_FROM_LEGACY[yuv420_jpeg.color_gamut]))
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        return _write_out(dest, blob, sdr.cg)

    def encode_api3(self, p010: JpegRUncompressed,
                    yuv420_jpeg: JpegRCompressed,
                    hdr_tf: UltrahdrTransferFunction,
                    dest: JpegRCompressed) -> Status:
        if yuv420_jpeg is None or yuv420_jpeg.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        st = self._validate(p010, None, hdr_tf, dest)
        if st != Status.JPEGR_NO_ERROR:
            return st
        try:
            blob = self._jr.encode_api3(
                _p010_to_raw(p010, hdr_tf),
                CompressedImage(bytes(yuv420_jpeg.data[:yuv420_jpeg.length]),
                                _CG_FROM_LEGACY[yuv420_jpeg.color_gamut]))
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        return _write_out(dest, blob,
                          _CG_FROM_LEGACY[yuv420_jpeg.color_gamut])

    def encode_api4(self, yuv420_jpeg: JpegRCompressed,
                    gainmap_jpeg: JpegRCompressed,
                    metadata: UltrahdrMetadata,
                    dest: JpegRCompressed) -> Status:
        if yuv420_jpeg is None or yuv420_jpeg.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if gainmap_jpeg is None or gainmap_jpeg.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if dest is None or dest.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        meta = GainMapMetadata(
            max_content_boost=np.full(3, metadata.max_content_boost,
                                      np.float32),
            min_content_boost=np.full(3, metadata.min_content_boost,
                                      np.float32),
            gamma=np.full(3, metadata.gamma, np.float32),
            offset_sdr=np.full(3, metadata.offset_sdr, np.float32),
            offset_hdr=np.full(3, metadata.offset_hdr, np.float32),
            hdr_capacity_min=metadata.hdr_capacity_min,
            hdr_capacity_max=metadata.hdr_capacity_max,
            use_base_cg=True)
        try:
            blob = self._jr.encode_api4(
                CompressedImage(bytes(yuv420_jpeg.data[:yuv420_jpeg.length]),
                                _CG_FROM_LEGACY[yuv420_jpeg.color_gamut]),
                CompressedImage(bytes(gainmap_jpeg.data[:gainmap_jpeg.length])),
                meta)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        return _write_out(dest, blob,
                          _CG_FROM_LEGACY[yuv420_jpeg.color_gamut])

    # -- info / decode (jpegr.cpp:2606-2758) -----------------------------

    def get_jpegr_info(self, jpegr_image: JpegRCompressed,
                       info: JpegRInfo) -> Status:
        if jpegr_image is None or jpegr_image.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if info is None:
            return Status.ERROR_JPEGR_BAD_PTR
        try:
            data = bytes(jpegr_image.data[:jpegr_image.length])
            d = self._jr.get_info(data)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        info.width, info.height = d["width"], d["height"]
        for key, slot in (("primary", "primary_img_info"),
                          ("gainmap", "gainmap_img_info")):
            pi = d[key]
            if pi is None or getattr(info, slot) is None:
                continue
            tgt = getattr(info, slot)
            tgt.width, tgt.height = pi.width, pi.height
            tgt.num_components = pi.num_components
            tgt.icc_data = pi.icc or b""
            tgt.exif_data = pi.exif or b""
            tgt.xmp_data = pi.xmp or b""
            tgt.iso_data = pi.iso or b""
        return Status.JPEGR_NO_ERROR

    def decode_jpegr(self, jpegr_image: JpegRCompressed,
                     dest: JpegRUncompressed,
                     max_display_boost: float = float("inf"),
                     exif: Optional[JpegRExif] = None,
                     output_format: UltrahdrOutputFormat =
                     UltrahdrOutputFormat.HDR_LINEAR,
                     gainmap_image: Optional[JpegRUncompressed] = None,
                     metadata: Optional[UltrahdrMetadata] = None) -> Status:
        if jpegr_image is None or jpegr_image.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if dest is None or dest.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if not (max_display_boost >= 1.0):
            return Status.ERROR_JPEGR_INVALID_DISPLAY_BOOST
        if exif is not None and exif.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if gainmap_image is not None and gainmap_image.data is None:
            return Status.ERROR_JPEGR_BAD_PTR
        if not (UltrahdrOutputFormat.SDR <= output_format
                <= UltrahdrOutputFormat.HDR_HLG):
            return Status.ERROR_JPEGR_INVALID_OUTPUT_FORMAT

        ct, fmt = {
            UltrahdrOutputFormat.HDR_HLG: (ColorTransfer.HLG,
                                           ImgFmt.RGBA1010102),
            UltrahdrOutputFormat.HDR_PQ: (ColorTransfer.PQ,
                                          ImgFmt.RGBA1010102),
            UltrahdrOutputFormat.HDR_LINEAR: (ColorTransfer.LINEAR,
                                              ImgFmt.RGBAF16),
            UltrahdrOutputFormat.SDR: (ColorTransfer.SRGB,
                                       ImgFmt.RGBA8888),
        }[output_format]

        data = bytes(jpegr_image.data[:jpegr_image.length])
        try:
            d = self._jr.get_info(data)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR
        if exif is not None:
            ed = d["primary"].exif or b""
            if exif.length < len(ed):
                return Status.ERROR_JPEGR_BUFFER_TOO_SMALL
            memoryview(exif.data)[:len(ed)] = ed
            exif.length = len(ed)
        try:
            img, meta, gm = self._jr.decode(
                data, output_ct=ct, output_fmt=fmt,
                max_display_boost=max_display_boost,
                return_gainmap=gainmap_image is not None)
        except (UhdrError, ValueError):
            return Status.JPEGR_UNKNOWN_ERROR

        out = np.ascontiguousarray(img.planes[0])
        raw = out.tobytes()
        view = memoryview(dest.data).cast("B")
        if len(view) < len(raw):
            return Status.ERROR_JPEGR_BUFFER_TOO_SMALL
        view[:len(raw)] = raw
        dest.width, dest.height = img.w, img.h
        dest.color_gamut = _CG_TO_LEGACY.get(img.cg,
                                             UltrahdrColorGamut.UNSPECIFIED)
        dest.color_range = img.range
        dest.pixel_format = img.fmt
        dest.chroma_data = None

        if gainmap_image is not None and gm is not None:
            graw = np.ascontiguousarray(gm.planes[0]).tobytes()
            gview = memoryview(gainmap_image.data).cast("B")
            if len(gview) < len(graw):
                return Status.ERROR_JPEGR_BUFFER_TOO_SMALL
            gview[:len(graw)] = graw
            gainmap_image.width, gainmap_image.height = gm.w, gm.h
            gainmap_image.pixel_format = gm.fmt
            gainmap_image.chroma_data = None
        if metadata is not None and meta is not None:
            if not meta.are_all_channels_identical():
                return Status.ERROR_JPEGR_METADATA_ERROR
            metadata.version = "1.0"
            metadata.max_content_boost = float(meta.max_content_boost[0])
            metadata.min_content_boost = float(meta.min_content_boost[0])
            metadata.gamma = float(meta.gamma[0])
            metadata.offset_sdr = float(meta.offset_sdr[0])
            metadata.offset_hdr = float(meta.offset_hdr[0])
            metadata.hdr_capacity_min = float(meta.hdr_capacity_min)
            metadata.hdr_capacity_max = float(meta.hdr_capacity_max)
        return Status.JPEGR_NO_ERROR
