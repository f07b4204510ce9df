"""JPEG_R codec orchestration, encode API-0 for P010 input.

Port of the encode-API-0 part of ``libultrahdr_tpu/jpegr.py`` (class JpegR,
after the reference's jpegr.cpp:135-200).  A ``JpegR`` carries the encoder
knobs and the device it computes on; the device is an explicit argument,
never looked up, and a CUDA request without a GPU raises.
"""

from __future__ import annotations

import torch

from .container import jpegr_container
from .errors import invalid_param, unsupported
from .fused import encode_api0_p010_fused
from .types import EncPreset, HDR_INPUT_FORMATS, ImgFmt, RawImage

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
