"""Public codec API, mirroring ultrahdr_api.h: the encoder and the decoder.

Port of the encoder and the decoder of ``libultrahdr_tpu/api.py``
(uhdr_create_encoder + uhdr_enc_*, ultrahdr_api.h:286-591; uhdr_create_decoder
+ uhdr_dec_*, ultrahdr_api.h:598-830): the same validation
(ultrahdr_api.cpp:815-1031) and the same lifecycle -- configure, then
``encode()`` / ``decode()`` seals ("sails") the context
(ultrahdrcommon.h:364), then getters, then ``reset()`` to reuse.  The
encoder selects API 0-4 from the resources that are set, as the reference
does.  The decoder gives every output of the reference: HLG and PQ as
RGBA1010102, LINEAR as RGBAF16 and SRGB as RGBA8888.

The effect queue (``add_effect_mirror/rotate/crop/resize``,
ultrahdr_api.cpp:117-269 on the encode side, :275-415 on the decode side)
runs on the host with the port's ``editor``, as in the JAX package: the
encoder edits its raw intents before API-0/1, the decoder edits its output
and its gain map, scaling crop and resize coordinates by their dimension
ratio.  ``enable_gpu_acceleration(False)`` selects the general path
(``use_fused=False``) of the encodes and the decode; either way the work
stays on the context's device.  ``JpegR.decode_to_device(effects=...)``
applies the same queue to the packed output on the device
(``ops/effects_device``).

    enc = UhdrEncoder()                 # the card; device="cpu" asks for the CPU
    enc.set_raw_image(hdr, ImgLabel.HDR)
    enc.set_quality(95, ImgLabel.BASE)
    data = enc.encode()

    dec = UhdrDecoder()
    dec.set_image(data)
    dec.set_out_color_transfer(ColorTransfer.HLG)
    dec.set_out_img_format(ImgFmt.RGBA1010102)
    img = dec.decode()
"""

from __future__ import annotations

import dataclasses
import math
import os

from . import editor
from .errors import (UhdrError, UhdrErrorCode, invalid_operation,
                     invalid_param, unsupported)
from .jpegr import (DEFAULT_ENC_PRESET, DEFAULT_GAINMAP_GAMMA,
                    DEFAULT_MAP_COMPRESS_QUALITY,
                    DEFAULT_MAP_DIMENSION_SCALE_FACTOR,
                    DEFAULT_USE_MULTI_CHANNEL_GAINMAP, FLT_MAX, JpegR,
                    JpegRParts, resolve_device)
from .jpegr import is_uhdr_image  # noqa: F401
from .types import (Codec, ColorGamut, ColorRange, ColorTransfer,
                    CompressedImage, EncPreset, GainMapMetadata,
                    HDR_INPUT_FORMATS, ImgFmt, ImgLabel, MIN_HEIGHT,
                    MIN_WIDTH, MirrorDirection, RawImage,
                    UHDR_MAX_DIMENSION)
from .utils import stage


# ---------------------------------------------------------------------------
# effects

@dataclasses.dataclass
class MirrorEffect:
    direction: MirrorDirection


@dataclasses.dataclass
class RotateEffect:
    degrees: int


@dataclasses.dataclass
class CropEffect:
    left: int
    right: int
    top: int
    bottom: int


@dataclasses.dataclass
class ResizeEffect:
    width: int
    height: int


def _apply_effect(effect, img: RawImage) -> RawImage:
    if isinstance(effect, MirrorEffect):
        return editor.apply_mirror(img, effect.direction)
    if isinstance(effect, RotateEffect):
        return editor.apply_rotate(img, effect.degrees)
    raise invalid_param(f"unsupported effect {effect}")


class _Context:
    """What the encoder and the decoder share (uhdr_codec_private,
    ultrahdrcommon.h:358-376): the device, the sailed state, the effect
    queue and the accelerated-path switch."""

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self._gpu = True
        self._reset_state()

    def _check_not_sailed(self):
        if self._sailed:
            raise invalid_operation(
                "An earlier call to encode/decode has sailed the context; "
                "reset to reuse")

    def enable_gpu_acceleration(self, enable: bool):
        """uhdr_enable_gpu_acceleration (ultrahdr_api.h:242).  Enabled (the
        default) selects the fused programs; disabled, the general path
        (``use_fused=False``) of the encodes and the decode, on the same
        device, as in the JAX package."""
        self._check_not_sailed()
        self._gpu = bool(enable)

    def add_effect_mirror(self, direction):
        self._check_not_sailed()
        try:
            direction = MirrorDirection(direction)
        except ValueError:
            raise invalid_param(f"invalid mirror direction {direction}")
        self._effects.append(MirrorEffect(direction))

    def add_effect_rotate(self, degrees: int):
        self._check_not_sailed()
        if degrees not in (90, 180, 270):
            raise invalid_param(f"unsupported rotation degrees {degrees}")
        self._effects.append(RotateEffect(int(degrees)))

    def add_effect_crop(self, left: int, right: int, top: int, bottom: int):
        self._check_not_sailed()
        self._effects.append(CropEffect(int(left), int(right), int(top),
                                        int(bottom)))

    def add_effect_resize(self, width: int, height: int):
        self._check_not_sailed()
        self._effects.append(ResizeEffect(int(width), int(height)))


def _validate_raw_image(img: RawImage, intent: ImgLabel):
    """The raw-image validation matrix (ultrahdr_api.cpp:815-1031)."""
    fmt, cg, ct = ImgFmt(img.fmt), ColorGamut(img.cg), ColorTransfer(img.ct)
    rng = ColorRange(img.range)
    if intent not in (ImgLabel.HDR, ImgLabel.SDR):
        raise invalid_param(
            f"invalid intent {intent}, expects hdr/sdr intent")
    if intent == ImgLabel.HDR and fmt not in (
            ImgFmt.P010, ImgFmt.RGBA1010102, ImgFmt.RGBAF16):
        raise invalid_param(f"unsupported color format of hdr intent {fmt}")
    if intent == ImgLabel.SDR and fmt not in (ImgFmt.YUV420,
                                              ImgFmt.RGBA8888):
        raise invalid_param(f"unsupported color format of sdr intent {fmt}")
    if cg not in (ColorGamut.BT2100, ColorGamut.DISPLAY_P3, ColorGamut.BT709):
        raise invalid_param(f"unsupported color gamut {cg}")
    if intent == ImgLabel.SDR and ct != ColorTransfer.SRGB:
        raise invalid_param(f"unsupported color transfer of sdr intent {ct}")
    if intent == ImgLabel.HDR:
        if fmt == ImgFmt.RGBAF16 and ct != ColorTransfer.LINEAR:
            raise invalid_param(
                f"unsupported color transfer {ct} for f16 hdr intent")
        if fmt != ImgFmt.RGBAF16 and ct not in (ColorTransfer.HLG,
                                                ColorTransfer.PQ):
            raise invalid_param(
                f"unsupported color transfer {ct} for hdr intent fmt {fmt}")
    if fmt in (ImgFmt.YUV420, ImgFmt.P010) and (img.w % 2 or img.h % 2):
        raise invalid_param(
            f"odd dims {img.w}x{img.h} with subsampled format {fmt}")
    if img.w < MIN_WIDTH or img.h < MIN_HEIGHT:
        raise invalid_param(f"image dims {img.w}x{img.h} below minimum 8x8")
    if img.w > UHDR_MAX_DIMENSION or img.h > UHDR_MAX_DIMENSION:
        raise invalid_param(
            f"image dims {img.w}x{img.h} above maximum {UHDR_MAX_DIMENSION}")
    expected = {ImgFmt.P010: 2, ImgFmt.YUV420: 3}.get(fmt, 1)
    if len([p for p in img.planes if p is not None]) < expected:
        raise invalid_param(f"received null pixel data for format {fmt}")
    if fmt == ImgFmt.P010:
        if rng not in (ColorRange.FULL, ColorRange.LIMITED):
            raise invalid_param(f"invalid color range {rng} for p010")
    elif rng != ColorRange.FULL:
        raise invalid_param(f"invalid color range {rng} for format {fmt}")


def validate_gainmap_metadata(m: GainMapMetadata):
    """uhdr_validate_gainmap_metadata_descriptor
    (ultrahdr_api.cpp:417-489)."""
    for i in range(3):
        vals = [m.min_content_boost[i], m.max_content_boost[i],
                m.offset_sdr[i], m.offset_hdr[i], m.hdr_capacity_min,
                m.hdr_capacity_max, m.gamma[i]]
        if not all(math.isfinite(float(v)) for v in vals):
            raise invalid_param("non-finite gainmap metadata field")
        if m.max_content_boost[i] < m.min_content_boost[i]:
            raise invalid_param("max content boost < min content boost")
        if m.min_content_boost[i] <= 0.0:
            raise invalid_param("min content boost must be > 0")
        if m.gamma[i] <= 0.0:
            raise invalid_param("gamma must be > 0")
        if m.offset_sdr[i] < 0.0 or m.offset_hdr[i] < 0.0:
            raise invalid_param("offsets must be >= 0")
        if m.hdr_capacity_max <= m.hdr_capacity_min:
            raise invalid_param("hdr capacity max must exceed min")
        if m.hdr_capacity_min < 1.0:
            raise invalid_param("hdr capacity min must be >= 1")


class UhdrEncoder(_Context):
    """uhdr_create_encoder + uhdr_enc_* (ultrahdr_api.h:286-591), on
    `device` (the card unless the caller asks for the CPU).

        enc = UhdrEncoder()
        enc.set_raw_image(hdr, ImgLabel.HDR)     # API-0
        enc.set_raw_image(sdr, ImgLabel.SDR)     # + API-1
        enc.set_quality(95, ImgLabel.BASE)
        data = enc.encode()
    """

    def _reset_state(self):
        self._sailed = False
        self._effects = []
        self._raw: dict[ImgLabel, RawImage] = {}
        self._compressed: dict[ImgLabel, CompressedImage] = {}
        self._gainmap_metadata: GainMapMetadata | None = None
        self._quality = {ImgLabel.BASE: 95,
                         ImgLabel.GAIN_MAP: DEFAULT_MAP_COMPRESS_QUALITY}
        self._exif: bytes | None = None
        self._scale_factor = DEFAULT_MAP_DIMENSION_SCALE_FACTOR
        self._multi_channel = DEFAULT_USE_MULTI_CHANNEL_GAINMAP
        self._gamma = DEFAULT_GAINMAP_GAMMA
        self._preset = DEFAULT_ENC_PRESET
        self._min_boost: float | None = None
        self._max_boost: float | None = None
        self._target_nits = -1.0
        self._output_format = Codec.JPG
        self._output: bytes | None = None
        self._encode_error: UhdrError | None = None

    # -- setters ---------------------------------------------------------

    def set_raw_image(self, img: RawImage, intent: ImgLabel):
        self._check_not_sailed()
        if img is None:
            raise invalid_param("received null raw image handle")
        intent = ImgLabel(intent)
        _validate_raw_image(img, intent)
        other = ImgLabel.SDR if intent == ImgLabel.HDR else ImgLabel.HDR
        if other in self._raw and (self._raw[other].w != img.w
                                   or self._raw[other].h != img.h):
            raise invalid_param(
                f"dimensions of sdr and hdr intents differ: {img.w}x{img.h} "
                f"vs {self._raw[other].w}x{self._raw[other].h}")
        self._raw[intent] = img

    def set_compressed_image(self, img: CompressedImage, intent: ImgLabel):
        self._check_not_sailed()
        intent = ImgLabel(intent)
        if intent not in (ImgLabel.HDR, ImgLabel.SDR, ImgLabel.BASE):
            raise invalid_param(
                f"invalid intent {intent}, expects sdr/hdr/base intent")
        if img is None or not img.data:
            raise invalid_param("received compressed image with no data")
        self._compressed[intent] = img

    def set_gainmap_image(self, img: CompressedImage,
                          metadata: GainMapMetadata):
        self._check_not_sailed()
        if img is None or not img.data:
            raise invalid_param("received gainmap image with no data")
        validate_gainmap_metadata(metadata)
        self._compressed[ImgLabel.GAIN_MAP] = img
        self._gainmap_metadata = metadata

    def set_quality(self, quality: int, intent: ImgLabel):
        self._check_not_sailed()
        intent = ImgLabel(intent)
        if intent not in (ImgLabel.BASE, ImgLabel.GAIN_MAP):
            raise invalid_param(f"invalid intent {intent} for quality")
        if not 0 <= int(quality) <= 100:
            raise invalid_param(f"quality factor {quality} not in [0, 100]")
        self._quality[intent] = int(quality)

    def set_exif_data(self, exif: bytes):
        self._check_not_sailed()
        if not exif:
            raise invalid_param("received no exif data")
        self._exif = bytes(exif)

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

    def set_min_max_content_boost(self, min_boost: float, max_boost: float):
        self._check_not_sailed()
        if not (math.isfinite(min_boost) and math.isfinite(max_boost)):
            raise invalid_param("content boosts must be finite")
        if min_boost <= 0:
            raise invalid_param(f"min content boost {min_boost} must be > 0")
        if max_boost < min_boost:
            raise invalid_param("max content boost must be >= min")
        self._min_boost, self._max_boost = float(min_boost), float(max_boost)

    def set_preset(self, preset: EncPreset):
        self._check_not_sailed()
        try:
            self._preset = EncPreset(preset)
        except ValueError:
            raise invalid_param(f"invalid preset {preset}")

    def set_target_display_peak_brightness(self, nits: float):
        self._check_not_sailed()
        if not 203.0 <= nits <= 10000.0:
            raise invalid_param(
                f"target peak brightness {nits} not in [203, 10000] nits")
        self._target_nits = float(nits)

    def set_output_format(self, media_type: Codec):
        self._check_not_sailed()
        media_type = Codec(media_type)
        if media_type != Codec.JPG:
            raise unsupported(f"output format {media_type} not supported")
        self._output_format = media_type

    # -- encode ----------------------------------------------------------

    def _apply_encoder_effects(self):
        """apply_effects on the raw intents (ultrahdr_api.cpp:117-269), on
        the host."""
        for eff in self._effects:
            for label in list(self._raw):
                img = self._raw[label]
                if isinstance(eff, CropEffect):
                    left = max(0, eff.left)
                    right = min(img.w, eff.right)
                    top = max(0, eff.top)
                    bottom = min(img.h, eff.bottom)
                    if right <= left or bottom <= top:
                        raise invalid_param(
                            f"invalid crop {left},{right},{top},{bottom}")
                    self._raw[label] = editor.apply_crop(
                        img, left, top, right - left, bottom - top)
                elif isinstance(eff, ResizeEffect):
                    if (eff.width <= 0 or eff.height <= 0
                            or eff.width > UHDR_MAX_DIMENSION
                            or eff.height > UHDR_MAX_DIMENSION):
                        raise invalid_param(
                            f"invalid resize {eff.width}x{eff.height}")
                    self._raw[label] = editor.apply_resize(
                        img, eff.width, eff.height)
                else:
                    self._raw[label] = _apply_effect(eff, img)

    def _check_no_effects(self):
        if self._effects:
            raise invalid_operation(
                "effects are not supported with compressed intents")

    def encode(self) -> bytes:
        """uhdr_encode (ultrahdr_api.cpp:1173-1310): sail the context,
        select API 0-4 by which resources are set, run JpegR; a second call
        returns the first result (or raises its error).  An ``encode`` span
        holds the request, the root of its spans (``utils.profiling``),
        with the HDR intent's format and the map's channels."""
        if self._sailed:
            if self._encode_error is not None:
                raise self._encode_error
            return self._output
        self._sailed = True
        hdr = self._raw.get(ImgLabel.HDR)
        try:
            with stage("encode",
                       fmt=None if hdr is None else ImgFmt(hdr.fmt).name,
                       map_channels=3 if self._multi_channel else 1):
                self._output = self._encode_impl()
            return self._output
        except UhdrError as e:
            self._encode_error = e
            raise

    def _encode_impl(self) -> bytes:
        jr = JpegR(device=self.device,
                   map_dimension_scale_factor=self._scale_factor,
                   map_compress_quality=self._quality[ImgLabel.GAIN_MAP],
                   use_multi_channel_gainmap=self._multi_channel,
                   gamma=self._gamma, preset=self._preset,
                   min_content_boost=self._min_boost,
                   max_content_boost=self._max_boost,
                   target_disp_peak_brightness=self._target_nits)
        base_q = self._quality[ImgLabel.BASE]
        has_sdr_raw = ImgLabel.SDR in self._raw
        has_sdr_comp = ImgLabel.SDR in self._compressed
        if ImgLabel.BASE in self._compressed \
                and ImgLabel.GAIN_MAP in self._compressed:
            self._check_no_effects()
            return jr.encode_api4(self._compressed[ImgLabel.BASE],
                                  self._compressed[ImgLabel.GAIN_MAP],
                                  self._gainmap_metadata)
        if ImgLabel.HDR not in self._raw:
            raise invalid_operation(
                "resources required for encoding are not set")
        if not has_sdr_raw and not has_sdr_comp:
            self._apply_encoder_effects()
            return jr.encode_api0(self._raw[ImgLabel.HDR], base_q,
                                  self._exif, use_fused=self._gpu)
        if has_sdr_comp and not has_sdr_raw:
            self._check_no_effects()
            return jr.encode_api3(self._raw[ImgLabel.HDR],
                                  self._compressed[ImgLabel.SDR])
        if has_sdr_raw and not has_sdr_comp:
            self._apply_encoder_effects()
            return jr.encode_api1(self._raw[ImgLabel.HDR],
                                  self._raw[ImgLabel.SDR], base_q,
                                  self._exif, use_fused=self._gpu)
        self._check_no_effects()
        return jr.encode_api2(self._raw[ImgLabel.HDR],
                              self._raw[ImgLabel.SDR],
                              self._compressed[ImgLabel.SDR])

    def get_encoded_stream(self) -> bytes | None:
        """uhdr_get_encoded_stream: None until a successful encode."""
        return self._output if self._sailed else None

    def reset(self):
        """uhdr_reset_encoder (ultrahdr_api.cpp:1325-1357)."""
        self._reset_state()


class UhdrDecoder(_Context):
    """uhdr_create_decoder + uhdr_dec_* (ultrahdr_api.h:598-830), on
    `device` (the card unless the caller asks for the CPU).  Defaults as the
    reference: RGBAF16 output, LINEAR transfer, max display boost
    FLT_MAX."""

    def _reset_state(self):
        self._sailed = False
        self._effects = []
        self._data: bytes | None = None
        self._output_fmt = ImgFmt.RGBAF16
        self._output_ct = ColorTransfer.LINEAR
        self._max_display_boost = FLT_MAX
        self._probed = False
        self._probe_error: UhdrError | None = None
        self._parts: JpegRParts | None = None
        self._decoded: RawImage | None = None
        self._gainmap_img: RawImage | None = None

    # -- setters ---------------------------------------------------------

    def set_image(self, data: bytes):
        self._check_not_sailed()
        if not data:
            raise invalid_param("received compressed image with no data")
        self._data = bytes(data)
        self._probed = False
        self._probe_error = None

    def set_out_img_format(self, fmt: ImgFmt):
        self._check_not_sailed()
        fmt = ImgFmt(fmt)
        if fmt not in (ImgFmt.RGBA8888, ImgFmt.RGBA1010102, ImgFmt.RGBAF16):
            raise invalid_param(f"unsupported output format {fmt}")
        self._output_fmt = fmt

    def set_out_color_transfer(self, ct: ColorTransfer):
        self._check_not_sailed()
        ct = ColorTransfer(ct)
        if ct not in (ColorTransfer.LINEAR, ColorTransfer.HLG,
                      ColorTransfer.PQ, ColorTransfer.SRGB):
            raise invalid_param(f"unsupported output transfer {ct}")
        self._output_ct = ct

    def set_out_max_display_boost(self, boost: float):
        self._check_not_sailed()
        if not boost >= 1.0:
            raise invalid_param(f"max display boost {boost} must be >= 1.0")
        self._max_display_boost = float(boost)

    # -- probe + getters (uhdr_dec_probe, ultrahdr_api.cpp:1542-1613) ----

    def probe(self):
        if self._probed:
            if self._probe_error is not None:
                raise self._probe_error
            return
        if self._data is None:
            raise invalid_operation("did not receive any image")
        try:
            self._probe_impl()
            self._probed = True
        except UhdrError as e:
            self._probed = True
            self._probe_error = e
            raise
        except Exception as e:
            # malformed input reports as a codec error, as the reference's
            # probe does; the traceback stays chained
            self._probed = True
            self._probe_error = UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                          str(e))
            raise self._probe_error from e

    def _probe_impl(self):
        """The request's one split and parse (``JpegR._parse_jpegr``),
        kept for the getters and the decode."""
        parts = JpegR._parse_jpegr(self._data)
        if parts.gm_jpeg is None:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "did not find gain map image")
        self._parts = parts

    def get_image_width(self) -> int:
        return self._parts.pinfo.width if self._parts else -1

    def get_image_height(self) -> int:
        return self._parts.pinfo.height if self._parts else -1

    def get_gainmap_width(self) -> int:
        return self._parts.gm_info.width if self._parts else -1

    def get_gainmap_height(self) -> int:
        return self._parts.gm_info.height if self._parts else -1

    def get_exif(self) -> bytes | None:
        return self._parts.pinfo.exif if self._parts else None

    def get_icc(self) -> bytes | None:
        return self._parts.pinfo.icc if self._parts else None

    def get_base_image(self) -> bytes | None:
        return self._parts.primary if self._parts else None

    def get_gainmap_image(self) -> bytes | None:
        return self._parts.gm_jpeg if self._parts else None

    def get_gainmap_metadata(self) -> GainMapMetadata | None:
        return self._parts.metadata if self._parts else None

    # -- decode ----------------------------------------------------------

    def decode(self) -> RawImage:
        """uhdr_decode (ultrahdr_api.cpp:1732-1814); a second call returns
        the first result.  The decode takes the probe's parts: a request
        splits and parses the file once.

        UHDR_TPU_DECODE_ENGINE chooses the engine, as in the JAX package:
        ``auto`` (the default) and ``device``: ``JpegR.decode`` on the
        decoder's device, the fused route or, for the streams it does not
        take, the general path; ``general``: the general path always;
        ``host``: the native host engine, ``JpegR.decode_host`` for HDR
        outputs (raising ``unsupported`` for the streams it does not take,
        with no retry) and ``JpegR.decode(engine="host")`` for SRGB.
        Unlike the JAX package's ``auto``, which tries the host engine
        first (a slow TPU link made it the faster one), ``auto`` stays on
        the device.  ``enable_gpu_acceleration(False)`` takes the
        general path whatever the engine.  The effect queue then edits the
        output and the gain map on the host (``_apply_decoder_effects``).
        A ``decode`` span holds the request, the root of its spans
        (``utils.profiling``)."""
        if self._sailed:
            return self._decoded
        with stage("decode", transfer=self._output_ct.name) as attrs:
            self.probe()
            parts = self._parts
            attrs.update(w=parts.pinfo.width, h=parts.pinfo.height)
            self._sailed = True
            fmt, ct = self._output_fmt, self._output_ct
            if ((fmt == ImgFmt.RGBA1010102 and ct not in (ColorTransfer.HLG,
                                                          ColorTransfer.PQ))
                    or (fmt == ImgFmt.RGBAF16 and ct != ColorTransfer.LINEAR)
                    or (fmt == ImgFmt.RGBA8888 and ct != ColorTransfer.SRGB)):
                raise invalid_param(
                    f"unsupported output pixel format {fmt} and output color "
                    f"transfer {ct} pair")
            jr = JpegR(device=self.device)
            engine = os.environ.get("UHDR_TPU_DECODE_ENGINE", "auto").lower()
            if self._gpu and engine == "host" and ct != ColorTransfer.SRGB:
                dest, _, gm_img = jr._decode_host_parsed(
                    parts, ct, self._max_display_boost, return_gainmap=True)
            else:
                dest, _, gm_img = jr._decode_parsed(
                    parts, ct, self._max_display_boost, return_gainmap=True,
                    use_fused=self._gpu and engine != "general",
                    engine="host" if self._gpu and engine == "host"
                    else "device")
            self._decoded = dest
            self._gainmap_img = gm_img
            if self._effects:
                self._apply_decoder_effects()
            return self._decoded

    def _apply_decoder_effects(self):
        """apply_effects after the decode (ultrahdr_api.cpp:275-415): every
        effect edits both the output image and the gain map, crop and resize
        coordinates scaled by the dimension ratio (floats, truncated)."""
        for eff in self._effects:
            disp, gm = self._decoded, self._gainmap_img
            if isinstance(eff, CropEffect):
                left = max(0, eff.left)
                right = min(disp.w, eff.right)
                top = max(0, eff.top)
                bottom = min(disp.h, eff.bottom)
                if right <= left or bottom <= top:
                    raise invalid_param("invalid crop dimensions")
                wd_ratio = disp.w / gm.w
                ht_ratio = disp.h / gm.h
                gm_l, gm_r = int(left / wd_ratio), int(right / wd_ratio)
                gm_t, gm_b = int(top / ht_ratio), int(bottom / ht_ratio)
                if gm_r <= gm_l or gm_b <= gm_t:
                    raise invalid_param("invalid gainmap crop dimensions")
                self._decoded = editor.apply_crop(disp, left, top,
                                                  right - left, bottom - top)
                self._gainmap_img = editor.apply_crop(
                    gm, gm_l, gm_t, gm_r - gm_l, gm_b - gm_t)
            elif isinstance(eff, ResizeEffect):
                dst_w, dst_h = eff.width, eff.height
                wd_ratio = disp.w / gm.w
                ht_ratio = disp.h / gm.h
                gm_w, gm_h = int(dst_w / wd_ratio), int(dst_h / ht_ratio)
                if (dst_w <= 0 or dst_h <= 0 or gm_w <= 0 or gm_h <= 0
                        or max(dst_w, dst_h, gm_w, gm_h) > UHDR_MAX_DIMENSION):
                    raise invalid_param(
                        f"unsupported resize dimensions {dst_w}x{dst_h}")
                self._decoded = editor.apply_resize(disp, dst_w, dst_h)
                self._gainmap_img = editor.apply_resize(gm, gm_w, gm_h)
            else:
                self._decoded = _apply_effect(eff, disp)
                self._gainmap_img = _apply_effect(eff, gm)

    def get_decoded_image(self) -> RawImage | None:
        return self._decoded if self._sailed else None

    def get_decoded_gainmap_image(self) -> RawImage | None:
        return self._gainmap_img if self._sailed else None

    def reset(self):
        """uhdr_reset_decoder (ultrahdr_api.cpp:1842-1871)."""
        self._reset_state()
