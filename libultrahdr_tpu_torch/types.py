"""Core datatypes mirroring the reference's public structs.

Reference: ultrahdr_api.h:91-283 (enums, uhdr_raw_image_t,
uhdr_compressed_image_t, uhdr_gainmap_metadata_t, uhdr_mem_block_t).

Unlike the C library (raw plane pointers + strides), images here are numpy
arrays on the host; device compute takes/returns planar float32 arrays.
Strides disappear — numpy views model any stride the C API could express,
which also gives us the reference's stride-invariance contract for free
(tests/jpegr_test.cpp:1537-1558).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .errors import invalid_param


class ImgFmt(enum.IntEnum):
    """uhdr_img_fmt_t (ultrahdr_api.h:91-118)."""

    UNSPECIFIED = -1
    P010 = 0              # UHDR_IMG_FMT_24bppYCbCrP010
    YUV420 = 1            # UHDR_IMG_FMT_12bppYCbCr420
    YUV400 = 2            # UHDR_IMG_FMT_8bppYCbCr400
    RGBA8888 = 3          # UHDR_IMG_FMT_32bppRGBA8888
    RGBAF16 = 4           # UHDR_IMG_FMT_64bppRGBAHalfFloat
    RGBA1010102 = 5       # UHDR_IMG_FMT_32bppRGBA1010102
    YUV444 = 6            # UHDR_IMG_FMT_24bppYCbCr444
    YUV422 = 7            # UHDR_IMG_FMT_16bppYCbCr422
    YUV440 = 8            # UHDR_IMG_FMT_16bppYCbCr440
    YUV411 = 9            # UHDR_IMG_FMT_12bppYCbCr411
    YUV410 = 10           # UHDR_IMG_FMT_10bppYCbCr410
    RGB888 = 11           # UHDR_IMG_FMT_24bppRGB888
    YUV444_10 = 12        # UHDR_IMG_FMT_30bppYCbCr444


class ColorGamut(enum.IntEnum):
    """uhdr_color_gamut_t (ultrahdr_api.h:121-126)."""

    UNSPECIFIED = -1
    BT709 = 0
    DISPLAY_P3 = 1
    BT2100 = 2


class ColorTransfer(enum.IntEnum):
    """uhdr_color_transfer_t (ultrahdr_api.h:129-135)."""

    UNSPECIFIED = -1
    LINEAR = 0
    HLG = 1
    PQ = 2
    SRGB = 3


class ColorRange(enum.IntEnum):
    """uhdr_color_range_t (ultrahdr_api.h:138-142)."""

    UNSPECIFIED = -1
    LIMITED = 0
    FULL = 1


class Codec(enum.IntEnum):
    """uhdr_codec_t (ultrahdr_api.h:145-149)."""

    JPG = 0
    HEIF = 1
    AVIF = 2


class ImgLabel(enum.IntEnum):
    """uhdr_img_label_t (ultrahdr_api.h:152-157)."""

    HDR = 0
    SDR = 1
    BASE = 2
    GAIN_MAP = 3


class EncPreset(enum.IntEnum):
    """uhdr_enc_preset_t (ultrahdr_api.h:160-163)."""

    REALTIME = 0
    BEST_QUALITY = 1


class MirrorDirection(enum.IntEnum):
    """uhdr_mirror_direction_t (ultrahdr_api.h:195-198)."""

    VERTICAL = 0
    HORIZONTAL = 1


# Formats where pixel data is a single packed/interleaved plane
# (gainmapmath.cpp isPixelFormatRgb + packed handling).
RGB_FORMATS = frozenset({ImgFmt.RGBA8888, ImgFmt.RGBAF16, ImgFmt.RGBA1010102, ImgFmt.RGB888})

HDR_INPUT_FORMATS = frozenset({ImgFmt.P010, ImgFmt.YUV444_10, ImgFmt.RGBA1010102, ImgFmt.RGBAF16})
SDR_INPUT_FORMATS = frozenset({ImgFmt.YUV444, ImgFmt.YUV422, ImgFmt.YUV420, ImgFmt.RGBA8888})

# Compile-time max dimension (jpegdecoderhelper.cpp:46-58, docs/building.md:66)
UHDR_MAX_DIMENSION = 8192
MIN_WIDTH = 8
MIN_HEIGHT = 8


@dataclasses.dataclass
class RawImage:
    """uhdr_raw_image_t (ultrahdr_api.h:212-231), numpy-backed.

    Plane conventions by fmt:
      P010:        planes = [Y uint16 (h, w), UV-interleaved uint16 (h//2, w)]
      YUV420:      planes = [Y u8 (h, w), U u8 (h//2, w//2), V u8 (h//2, w//2)]
      YUV422:      planes = [Y u8 (h, w), U u8 (h, w//2), V u8 (h, w//2)]
      YUV444:      planes = [Y u8 (h, w), U u8 (h, w), V u8 (h, w)]
      YUV444_10:   same layout, uint16
      YUV400:      planes = [Y u8 (h, w)]
      RGBA8888:    planes = [uint32 (h, w)]   (packed ABGR little-endian: R lowest byte)
      RGBA1010102: planes = [uint32 (h, w)]
      RGBAF16:     planes = [uint16 (h, w, 4)]  (half-float bits r,g,b,a;
                   view-cast of the C API's packed little-endian uint64)
      RGB888:      planes = [uint8 (h, w, 3)]
    """

    fmt: ImgFmt
    cg: ColorGamut
    ct: ColorTransfer
    range: ColorRange
    w: int
    h: int
    planes: list  # list[np.ndarray]

    def copy(self) -> "RawImage":
        return RawImage(self.fmt, self.cg, self.ct, self.range, self.w, self.h,
                        [np.array(p, copy=True) for p in self.planes])


@dataclasses.dataclass
class CompressedImage:
    """uhdr_compressed_image_t (ultrahdr_api.h:234-241)."""

    data: bytes
    cg: ColorGamut = ColorGamut.UNSPECIFIED
    ct: ColorTransfer = ColorTransfer.UNSPECIFIED
    range: ColorRange = ColorRange.UNSPECIFIED


@dataclasses.dataclass
class GainMapMetadata:
    """uhdr_gainmap_metadata_t, extended (ultrahdr_api.h:244-263,
    ultrahdrcommon.h uhdr_gainmap_metadata_ext_t).

    min/max_content_boost, gamma, offsets are per-channel (3 entries);
    hdr_capacity_{min,max} are scalars.  All linear-space (not log2) —
    matching the public struct, with ISO/XMP writers converting to log2.
    """

    max_content_boost: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    min_content_boost: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    gamma: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    offset_sdr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    offset_hdr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    hdr_capacity_min: float = 1.0
    hdr_capacity_max: float = 1.0
    use_base_cg: bool = True

    def are_all_channels_identical(self) -> bool:
        """uhdr_gainmap_metadata_ext_t::are_all_channels_identical."""
        return bool(
            np.all(self.max_content_boost == self.max_content_boost[0])
            and np.all(self.min_content_boost == self.min_content_boost[0])
            and np.all(self.gamma == self.gamma[0])
            and np.all(self.offset_sdr == self.offset_sdr[0])
            and np.all(self.offset_hdr == self.offset_hdr[0]))

    def copy(self) -> "GainMapMetadata":
        return GainMapMetadata(
            np.array(self.max_content_boost, np.float32),
            np.array(self.min_content_boost, np.float32),
            np.array(self.gamma, np.float32),
            np.array(self.offset_sdr, np.float32),
            np.array(self.offset_hdr, np.float32),
            float(self.hdr_capacity_min), float(self.hdr_capacity_max),
            bool(self.use_base_cg))


def validate_image_dims(w: int, h: int) -> None:
    """Dim checks per jpegdecoderhelper.cpp:46-58 and encoder validation."""
    if not (MIN_WIDTH <= w <= UHDR_MAX_DIMENSION and MIN_HEIGHT <= h <= UHDR_MAX_DIMENSION):
        raise invalid_param(
            f"image dimensions {w}x{h} outside supported range "
            f"[{MIN_WIDTH}..{UHDR_MAX_DIMENSION}]")


def alloc_raw_image(fmt: ImgFmt, cg: ColorGamut, ct: ColorTransfer,
                    rng: ColorRange, w: int, h: int) -> RawImage:
    """Analog of uhdr_raw_image_ext_t allocation (ultrahdr_api.cpp:36-103)."""
    if fmt == ImgFmt.P010:
        planes = [np.zeros((h, w), np.uint16), np.zeros((h // 2, w), np.uint16)]
    elif fmt == ImgFmt.YUV420:
        planes = [np.zeros((h, w), np.uint8),
                  np.zeros((h // 2, w // 2), np.uint8),
                  np.zeros((h // 2, w // 2), np.uint8)]
    elif fmt == ImgFmt.YUV422:
        planes = [np.zeros((h, w), np.uint8),
                  np.zeros((h, w // 2), np.uint8),
                  np.zeros((h, w // 2), np.uint8)]
    elif fmt == ImgFmt.YUV444:
        planes = [np.zeros((h, w), np.uint8) for _ in range(3)]
    elif fmt == ImgFmt.YUV444_10:
        planes = [np.zeros((h, w), np.uint16) for _ in range(3)]
    elif fmt == ImgFmt.YUV400:
        planes = [np.zeros((h, w), np.uint8)]
    elif fmt in (ImgFmt.RGBA8888, ImgFmt.RGBA1010102):
        planes = [np.zeros((h, w), np.uint32)]
    elif fmt == ImgFmt.RGBAF16:
        planes = [np.zeros((h, w, 4), np.uint16)]
    elif fmt == ImgFmt.RGB888:
        planes = [np.zeros((h, w, 3), np.uint8)]
    else:
        raise invalid_param(f"cannot allocate image with format {fmt}")
    return RawImage(fmt, cg, ct, rng, w, h, planes)
