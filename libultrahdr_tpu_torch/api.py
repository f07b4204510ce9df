"""Public encoder API, API-0 side, mirroring ultrahdr_api.h.

Port of the API-0 encode part of ``libultrahdr_tpu/api.py``
(uhdr_create_encoder + uhdr_enc_*, ultrahdr_api.h:286-591): the setters the
API-0 encode reads, the same validation (ultrahdr_api.cpp:815-1031) and the
same lifecycle -- configure, then ``encode()`` seals ("sails") the context
(ultrahdrcommon.h:364), then getters, then ``reset()`` to reuse.  The other
setters and scenarios (SDR intents, compressed intents, effects, presets,
boosts) come with the other encode paths (ROADMAP.md, Queue 1).

    enc = UhdrEncoder(device="cuda")
    enc.set_raw_image(hdr, ImgLabel.HDR)
    enc.set_quality(95, ImgLabel.BASE)
    data = enc.encode()
"""

from __future__ import annotations

import math

from .errors import UhdrError, invalid_operation, invalid_param, unsupported
from .jpegr import (DEFAULT_GAINMAP_GAMMA, DEFAULT_MAP_COMPRESS_QUALITY,
                    DEFAULT_MAP_DIMENSION_SCALE_FACTOR,
                    DEFAULT_USE_MULTI_CHANNEL_GAINMAP, JpegR, resolve_device)
from .types import (ColorGamut, ColorRange, ColorTransfer, ImgFmt, ImgLabel,
                    MIN_HEIGHT, MIN_WIDTH, RawImage, UHDR_MAX_DIMENSION)


def _validate_hdr_image(img: RawImage):
    """The HDR-intent rows of the raw-image validation matrix
    (ultrahdr_api.cpp:815-1031)."""
    fmt, cg, ct = ImgFmt(img.fmt), ColorGamut(img.cg), ColorTransfer(img.ct)
    rng = ColorRange(img.range)
    if fmt not in (ImgFmt.P010, ImgFmt.RGBA1010102, ImgFmt.RGBAF16):
        raise invalid_param(f"unsupported color format of hdr intent {fmt}")
    if cg not in (ColorGamut.BT2100, ColorGamut.DISPLAY_P3, ColorGamut.BT709):
        raise invalid_param(f"unsupported color gamut {cg}")
    if fmt == ImgFmt.RGBAF16 and ct != ColorTransfer.LINEAR:
        raise invalid_param(
            f"unsupported color transfer {ct} for f16 hdr intent")
    if fmt != ImgFmt.RGBAF16 and ct not in (ColorTransfer.HLG,
                                            ColorTransfer.PQ):
        raise invalid_param(
            f"unsupported color transfer {ct} for hdr intent fmt {fmt}")
    if fmt == ImgFmt.P010 and (img.w % 2 or img.h % 2):
        raise invalid_param(
            f"odd dims {img.w}x{img.h} with subsampled format {fmt}")
    if img.w < MIN_WIDTH or img.h < MIN_HEIGHT:
        raise invalid_param(f"image dims {img.w}x{img.h} below minimum 8x8")
    if img.w > UHDR_MAX_DIMENSION or img.h > UHDR_MAX_DIMENSION:
        raise invalid_param(
            f"image dims {img.w}x{img.h} above maximum {UHDR_MAX_DIMENSION}")
    expected = 2 if fmt == ImgFmt.P010 else 1
    if len([p for p in img.planes if p is not None]) < expected:
        raise invalid_param(f"received null pixel data for format {fmt}")
    if fmt == ImgFmt.P010:
        if rng not in (ColorRange.FULL, ColorRange.LIMITED):
            raise invalid_param(f"invalid color range {rng} for p010")
    elif rng != ColorRange.FULL:
        raise invalid_param(f"invalid color range {rng} for format {fmt}")


class UhdrEncoder:
    """uhdr_create_encoder + the API-0 uhdr_enc_* calls, on `device`."""

    def __init__(self, *, device):
        self.device = resolve_device(device)
        self._reset_state()

    def _reset_state(self):
        self._sailed = False
        self._raw: dict[ImgLabel, RawImage] = {}
        self._quality = {ImgLabel.BASE: 95,
                         ImgLabel.GAIN_MAP: DEFAULT_MAP_COMPRESS_QUALITY}
        self._scale_factor = DEFAULT_MAP_DIMENSION_SCALE_FACTOR
        self._multi_channel = DEFAULT_USE_MULTI_CHANNEL_GAINMAP
        self._gamma = DEFAULT_GAINMAP_GAMMA
        self._output: bytes | None = None
        self._encode_error: UhdrError | None = None

    def _check_not_sailed(self):
        if self._sailed:
            raise invalid_operation(
                "An earlier call to encode/decode has sailed the context; "
                "reset to reuse")

    # -- setters ---------------------------------------------------------

    def set_raw_image(self, img: RawImage, intent: ImgLabel):
        self._check_not_sailed()
        if img is None:
            raise invalid_param("received null raw image handle")
        intent = ImgLabel(intent)
        if intent == ImgLabel.SDR:
            raise unsupported("SDR intents (API-1/2) are not ported yet "
                              "(ROADMAP.md, Queue 1: the other encode "
                              "formats and APIs)")
        if intent != ImgLabel.HDR:
            raise invalid_param(
                f"invalid intent {intent}, expects hdr/sdr intent")
        _validate_hdr_image(img)
        self._raw[intent] = img

    def set_quality(self, quality: int, intent: ImgLabel):
        self._check_not_sailed()
        intent = ImgLabel(intent)
        if intent not in (ImgLabel.BASE, ImgLabel.GAIN_MAP):
            raise invalid_param(f"invalid intent {intent} for quality")
        if not 0 <= int(quality) <= 100:
            raise invalid_param(f"quality factor {quality} not in [0, 100]")
        self._quality[intent] = int(quality)

    def set_using_multi_channel_gainmap(self, use: bool):
        self._check_not_sailed()
        self._multi_channel = bool(use)

    def set_gainmap_scale_factor(self, factor: int):
        self._check_not_sailed()
        if not 1 <= int(factor) <= 128:
            raise invalid_param(
                f"gainmap scale factor {factor} not in [1, 128]")
        self._scale_factor = int(factor)

    def set_gainmap_gamma(self, gamma: float):
        self._check_not_sailed()
        if not (gamma > 0 and math.isfinite(gamma)):
            raise invalid_param(f"gamma {gamma} must be positive and finite")
        self._gamma = float(gamma)

    # -- encode ----------------------------------------------------------

    def encode(self) -> bytes:
        """uhdr_encode (ultrahdr_api.cpp:1173-1310): sail the context and
        run the API-0 encode; a second call returns the first result (or
        raises its error)."""
        if self._sailed:
            if self._encode_error is not None:
                raise self._encode_error
            return self._output
        self._sailed = True
        try:
            self._output = self._encode_impl()
            return self._output
        except UhdrError as e:
            self._encode_error = e
            raise

    def _encode_impl(self) -> bytes:
        if ImgLabel.HDR not in self._raw:
            raise invalid_operation(
                "resources required for encoding are not set")
        jr = JpegR(device=self.device,
                   map_dimension_scale_factor=self._scale_factor,
                   map_compress_quality=self._quality[ImgLabel.GAIN_MAP],
                   use_multi_channel_gainmap=self._multi_channel,
                   gamma=self._gamma)
        return jr.encode_api0(self._raw[ImgLabel.HDR],
                              self._quality[ImgLabel.BASE])

    def get_encoded_stream(self) -> bytes | None:
        """uhdr_get_encoded_stream: None until a successful encode."""
        return self._output if self._sailed else None

    def reset(self):
        """uhdr_reset_encoder (ultrahdr_api.cpp:1325-1357)."""
        self._reset_state()
