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

The decode to HLG or PQ (RGBA1010102) and LINEAR (RGBAF16) takes the fused
route for a baseline JPEG_R whose base is 4:4:4, 4:2:2, 4:2:0 or 4:4:0 and
whose gain map is 1 or 3 full-resolution channels at an integer scale, and
the general path (``decode(use_fused=False)``, the JAX package's
``decode`` after ``_try_decode_fused`` returns None) for every other
stream: a progressive or grayscale base, a progressive or subsampled
3-channel map, a map whose size does not divide the image (the fractional
IDW, ``ops/idw.idw_upsample_fractional``) or whose aspect ratio is more than
1% off (``editor.resize_channels`` on the host, then the upload).  Which
route a stream takes is decided from its parsed headers before anything is
uploaded or launched (``_fused_plan``); both routes end in the same apply
kernel launch (``apply_gainmap``).  The SRGB output (RGBA8888) is the base
image's own RGB decode on the device, and its gain map is decoded only when
the caller asks for it.

``decode_host`` is the JAX package's native host engine: the Huffman decode,
a float IDCT and the apply in the host C++ (``jpeg/native.py``), touching no
tensor; it raises ``unsupported`` for the streams the fused route does not
take, as the JAX package's does.

``decode_to_device`` leaves the output on the device.  By default
concurrent callers are coalesced (``_DeviceDecodeMicrobatcher``) into one
``decode_to_device_batch``: the host Huffman decodes of a group of streams
run on a thread pool, and each image's upload and device stages run on a
side stream as soon as its Huffman decode ends, one apply-kernel launch an
image.

The fused routes' transfers are raw unless a knob asks for a wire
(``wire.py``): with ``UHDR_TPU_WIRE`` set, each image's coefficient planes
go up as one ``pack_coeff_wire_best`` blob (packed on the batch's host pool;
a batch group keeps the wire kind of its first member, the others take the
per-image route, as in the JAX package); with ``UHDR_TPU_WIRE_DOWN`` set,
``decode``'s fused output comes down through ``fetch_packed_1010102`` /
``fetch_packed_f16``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import threading
import time

import numpy as np
import torch

from . import fused, wire
from .container import icc as icc_mod
from .container import iso21496, jpegr_container, segments, xmp
from .container.xmp import JPEGR_VERSION  # noqa: F401  (JAX's name)
from .editor import resize_channels
from .errors import UhdrError, UhdrErrorCode, invalid_param, unsupported
from .jpeg import native
from .jpeg.decoder import (decode_coefficients, decode_to_planes,
                           decode_to_rgb, decode_to_rgba,
                           get_output_sampling_format, parse_jpeg,
                           planes_to_rgb)
from .jpeg.encoder import JpegEncoder
from .ops import apply as apply_ops
from .ops import colors, effects_device, gainmap as gainmap_ops, idw, pixel
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


class _DeviceDecodeMicrobatcher:
    """Request coalescing for ``decode_to_device`` (the JAX package's
    microbatcher, kept as it is): concurrent callers land in a queue per
    (output transfer, boost); the first caller of a window leads.  It waits
    up to `window_s` (or until `max_k` requests queue), then dispatches ONE
    ``decode_to_device_batch`` over the snapshot (in chunks of `max_k`) and
    hands each caller its result.  On any batch error the leader retries
    each request alone on the per-image route, so one bad stream cannot fail
    its neighbours.  Every launch happens on the leader's thread.

    ``batches`` counts the batch dispatches (chunks of two or more) and
    ``retries`` the requests retried alone after a batch error."""

    def __init__(self, window_s: float | None = None,
                 max_k: int | None = None):
        self.window_s = window_s if window_s is not None else float(
            os.environ.get("UHDR_TPU_DECODE_MB_WINDOW_MS", "4")) / 1e3
        self.max_k = max_k if max_k is not None else int(
            os.environ.get("UHDR_TPU_DECODE_MB_K", "8"))
        self.batches = 0
        self.retries = 0
        self._lock = threading.Lock()
        self._groups: dict[tuple, list] = {}

    def run(self, jr, data: bytes, key: tuple):
        ev = threading.Event()
        slot: dict = {}
        with self._lock:
            group = self._groups.setdefault(key, [])
            group.append((data, ev, slot))
            leader = len(group) == 1
        if not leader:
            ev.wait()
            if "exc" in slot:
                raise slot["exc"]
            return slot["out"]
        deadline = time.monotonic() + self.window_s
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._groups[key]) >= self.max_k:
                    break
            time.sleep(0.0005)
        with self._lock:
            reqs = self._groups.pop(key)
        output_ct, boost = key
        try:
            outs = []
            for i in range(0, len(reqs), self.max_k):
                chunk = reqs[i:i + self.max_k]
                if len(chunk) == 1:
                    outs.append(jr._decode_to_device_one(
                        chunk[0][0], output_ct, boost))
                else:
                    outs.extend(jr.decode_to_device_batch(
                        [r[0] for r in chunk], output_ct, boost))
                    with self._lock:
                        self.batches += 1
            for (_, ev2, sl), out in zip(reqs, outs):
                sl["out"] = out
                ev2.set()
        except Exception:
            with self._lock:
                self.retries += len(reqs)
            for d, ev2, sl in reqs:
                try:
                    sl["out"] = jr._decode_to_device_one(d, output_ct,
                                                         boost)
                except Exception as e:  # propagate per caller
                    sl["exc"] = e
                ev2.set()
        if "exc" in slot:
            raise slot["exc"]
        return slot["out"]


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

    def __init__(self,
                 map_dimension_scale_factor: int = DEFAULT_MAP_DIMENSION_SCALE_FACTOR,
                 map_compress_quality: int = DEFAULT_MAP_COMPRESS_QUALITY,
                 use_multi_channel_gainmap: bool = DEFAULT_USE_MULTI_CHANNEL_GAINMAP,
                 gamma: float = DEFAULT_GAINMAP_GAMMA,
                 preset: EncPreset = DEFAULT_ENC_PRESET,
                 min_content_boost: float | None = None,
                 max_content_boost: float | None = None,
                 target_disp_peak_brightness: float = DEFAULT_TARGET_DISP_PEAK_BRIGHTNESS,
                 write_iso: bool | None = None, write_xmp: bool | None = None,
                 *, device="cuda"):
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
                                       device=self.device)
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

    @staticmethod
    def parse_gainmap_metadata(iso: bytes | None, xmp_blob: bytes | None,
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

    def _parse_jpegr(self, data: bytes, need_gainmap: bool = True):
        """Split and parse a JPEG_R file: (primary, pinfo, gm_jpeg, gm_info,
        metadata, sdr_cg, gm_cg).  Without `need_gainmap` (an SRGB output
        that does not return the map) the gain map is neither demanded nor
        parsed, and gm_info, metadata and gm_cg are None."""
        primary, gm_jpeg = self.extract_primary_and_gainmap(data)
        pinfo = parse_jpeg(primary)
        sdr_cg = icc_mod.read_icc_color_gamut(pinfo.icc) if pinfo.icc \
            else ColorGamut.UNSPECIFIED
        if not need_gainmap:
            return primary, pinfo, gm_jpeg, None, None, sdr_cg, None
        if gm_jpeg is None:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "no gain map image present")
        gm_info = parse_jpeg(gm_jpeg)
        metadata = self.parse_gainmap_metadata(gm_info.iso, gm_info.xmp,
                                               pinfo.exif)
        gm_cg = icc_mod.read_icc_color_gamut(gm_info.icc) if gm_info.icc \
            else ColorGamut.UNSPECIFIED
        return primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg

    def decode(self, data: bytes, output_ct=ColorTransfer.HLG,
               output_fmt=ImgFmt.RGBA1010102,
               max_display_boost: float = FLT_MAX,
               return_gainmap: bool = False, use_fused: bool = True, *,
               engine: str = "device"):
        """decodeJPEGR (jpegr.cpp:1384-1446).

        Returns (RawImage dest, GainMapMetadata, gainmap RawImage | None).
        SRGB output is the base image's RGB decode as RGBA8888 (metadata
        None unless the gain map is returned), on ``self.device`` or, for
        `engine` "host", by the host engine (``decode_to_rgba``), which is
        the JAX package's SRGB route; HDR outputs do not read `engine`
        (``decode_host`` is the host engine's).  HDR output takes the fused
        route when ``_fused_plan`` takes the stream and `use_fused` is set,
        else the general path; its format follows the transfer (HLG/PQ:
        RGBA1010102, LINEAR: RGBAF16) as in the JAX package; `output_fmt`
        is accepted for the same signature and not read."""
        del output_fmt
        output_ct = ColorTransfer(output_ct)
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data, need_gainmap=(
                output_ct != ColorTransfer.SRGB or return_gainmap))
        if output_ct == ColorTransfer.SRGB:
            dest = RawImage(ImgFmt.RGBA8888, sdr_cg, ColorTransfer.SRGB,
                            ColorRange.FULL, pinfo.width, pinfo.height,
                            [decode_to_rgba(primary, pinfo, engine=engine,
                                            device=self.device)])
            gainmap_img = self._decode_gainmap_image(gm_jpeg, gm_info,
                                                     engine) \
                if return_gainmap else None
            return dest, metadata, gainmap_img
        plan = self._fused_plan(pinfo, gm_info, metadata, sdr_cg, gm_cg,
                                output_ct) if use_fused else None
        if plan is not None:
            dest, gainmap_img = self._try_decode_fused(
                plan, primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
                max_display_boost, gm_cg)
        else:
            dest, gainmap_img = self._decode_general(
                primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
                max_display_boost, sdr_cg, gm_cg)
        return dest, metadata, gainmap_img if return_gainmap else None

    def _decode_general(self, primary, pinfo, gm_jpeg, gm_info, metadata,
                        output_ct, max_display_boost, sdr_cg, gm_cg):
        """The general decode path on ``self.device`` (the JAX package's
        ``decode`` after its fused route declines): ``_general_planes``,
        then ``apply_gainmap``.  Returns (dest RawImage, gainmap RawImage)
        in host memory."""
        sdr, gain_u8 = self._general_planes(primary, pinfo, gm_jpeg, gm_info,
                                            sdr_cg)
        dest = self.apply_gainmap(sdr, gain_u8, gm_cg, metadata, output_ct,
                                  None, max_display_boost)
        return dest, _gainmap_image(gain_u8, gm_cg)

    def _general_planes(self, primary, pinfo, gm_jpeg, gm_info, sdr_cg):
        """Both images decoded on ``self.device`` (baseline or progressive):
        (the base as an SDR RawImage of device planes, the (C, mh, mw) u8
        gain map: a YUV400 map's luma, else the RGB decode of the RGB-coded
        map, DECODE_STREAM)."""
        planes, base_fmt = decode_to_planes(primary, pinfo,
                                            device=self.device)
        gm_planes, gm_fmt = decode_to_planes(gm_jpeg, gm_info,
                                             device=self.device)
        gain_u8 = planes_to_rgb(gm_planes, gm_fmt, gm_info.height,
                                gm_info.width)
        return RawImage(base_fmt, sdr_cg, ColorTransfer.SRGB, ColorRange.FULL,
                        pinfo.width, pinfo.height, planes), gain_u8

    def _decode_gainmap_image(self, gm_jpeg: bytes, gm_info,
                              engine: str = "device") -> RawImage:
        """The gain-map image decoded on its own (uhdr_get_decoded_gainmap
        on the SRGB path, ultrahdr_api.cpp:1815-1840), on ``self.device``
        or, for engine "host", by the host engine (as the JAX package
        does)."""
        gm_cg = icc_mod.read_icc_color_gamut(gm_info.icc) if gm_info.icc \
            else ColorGamut.UNSPECIFIED
        if engine == "host":
            packed = decode_to_rgba(gm_jpeg, gm_info, engine="host")
            rgb = packed.view(np.uint8).reshape(*packed.shape, 4)
            gm = rgb[..., :1] if gm_info.num_components == 1 else rgb[..., :3]
            return _gainmap_image(torch.from_numpy(gm).permute(2, 0, 1),
                                  gm_cg)
        return _gainmap_image(
            decode_to_rgb(gm_jpeg, gm_info, device=self.device), gm_cg)

    def _try_decode_fused(self, plan: dict, primary, pinfo, gm_jpeg,
                          gm_info, metadata, output_ct, max_display_boost,
                          gm_cg):
        """The fused decode of a stream that `plan` (``_fused_plan``) takes:
        (dest RawImage, gainmap RawImage) in host memory, the output
        downloaded raw or, with UHDR_TPU_WIRE_DOWN set, through the download
        wire."""
        packed_dev, gm_dev = self._decode_planned(
            plan, fused.decode_coefficients(primary, pinfo),
            fused.decode_coefficients(gm_jpeg, gm_info), metadata,
            output_ct, max_display_boost)
        if wire.down_wire_enabled():
            fetch = fused.fetch_packed_f16 \
                if ColorTransfer(output_ct) == ColorTransfer.LINEAR \
                else fused.fetch_packed_1010102
            packed_dev = fetch(packed_dev, h=pinfo.height, w=pinfo.width)
        return (_output_image(packed_dev, plan["hdr_cg"], output_ct,
                              pinfo.width, pinfo.height),
                _gainmap_image(gm_dev, gm_cg))

    @staticmethod
    def _fused_plan(pinfo, gm_info, metadata, sdr_cg, gm_cg,
                    output_ct=ColorTransfer.HLG) -> dict | None:
        """The fused route's parameters of a parsed stream, in the order of
        the batch signature (w, h, sampling key, scale_k, gm_channels,
        s_cg, h_cg, use_base_cg), or None for a stream the fused route does
        not take, as the JAX package's ``_decode_fused_device`` declines
        it: an output other than HLG/PQ/LINEAR, a progressive image, a base
        of other than 3 components or a map of other than 1 or 3, a base
        sampled other than 4:4:4, 4:2:2, 4:2:0 or 4:4:0, a subsampled
        3-channel map, or a map whose size does not divide the image by one
        integer factor."""
        if ColorTransfer(output_ct) not in _DECODE_OUTPUTS:
            return None
        if pinfo.progressive or gm_info.progressive:
            return None
        if pinfo.num_components != 3 or gm_info.num_components not in (1, 3):
            return None
        try:
            key = _SAMPLING_KEY.get(get_output_sampling_format(pinfo))
        except UhdrError:
            return None
        if key is None or (gm_info.num_components == 3 and any(
                c.h != 1 or c.v != 1 for c in gm_info.components)):
            return None
        w, h = pinfo.width, pinfo.height
        mw, mh = gm_info.width, gm_info.height
        if mw == 0 or mh == 0 or w % mw or h % mh or w // mw != h // mh:
            return None
        s_cg = ColorGamut(sdr_cg)
        if s_cg == ColorGamut.UNSPECIFIED:
            s_cg = ColorGamut.BT709
        h_cg = ColorGamut(gm_cg)
        if h_cg == ColorGamut.UNSPECIFIED:
            h_cg = s_cg
        return {"w": w, "h": h, "sampling_key": key, "scale_k": w // mw,
                "gm_channels": gm_info.num_components, "sdr_cg": s_cg,
                "hdr_cg": h_cg, "use_base_cg": bool(metadata.use_base_cg)}

    def _decode_planned(self, plan: dict, base, gm, metadata, output_ct,
                        max_display_boost, device=None, coeff_wire=None):
        """The device half of a fused decode on `device` (by default
        ``self.device``) from the host Huffman decode of both images
        (``fused.decode_coefficients`` results, the coefficient planes as
        host arrays or pinned tensors): the upload, ``_decode_device_core``
        with one apply launch.  Returns (packed output, gain map u8).

        The planes go up raw, or with UHDR_TPU_WIRE set as one
        ``pack_coeff_wire_best`` blob: `coeff_wire` (a
        ``wire.pack_coeff_blob`` result), packed here when not given."""
        device = torch.device(device or self.device)
        weight = apply_ops.gainmap_weight(
            max_display_boost, float(metadata.hdr_capacity_min),
            float(metadata.hdr_capacity_max))
        if coeff_wire is None and wire.coeff_wire_enabled():
            coeff_wire = wire.pack_coeff_blob(
                list(base[0]) + list(gm[0]), stage=device.type == "cuda")
        if coeff_wire is not None:
            planes = wire.upload_coeff_blob(coeff_wire, device)
            base_c, gm_c = planes[:len(base[0])], planes[len(base[0]):]
        else:
            base_c = fused.upload_coeff_planes(base[0], device)
            gm_c = fused.upload_coeff_planes(gm[0], device)
        return fused._decode_device_core(
            base_c, base[1], gm_c, gm[1],
            apply_ops.metadata_to_arrays(metadata), np.float32(weight),
            out_ct=output_ct, **plan)

    def _decode_fused_device(self, primary, pinfo, gm_jpeg, gm_info,
                             metadata, output_ct, max_display_boost, sdr_cg,
                             gm_cg):
        """Device half of the fused decode on ``self.device``; returns
        (packed output, gain map u8, hdr gamut) with the tensors left on the
        device.  A stream the fused route does not take raises
        ``unsupported``: the device-resident decode has no general path, as
        in the JAX package."""
        plan = self._fused_plan(pinfo, gm_info, metadata, sdr_cg, gm_cg,
                                output_ct)
        if plan is None:
            raise unsupported(
                "stream shape not supported by the fused decode path")
        packed, gm_u8 = self._decode_planned(
            plan, fused.decode_coefficients(primary, pinfo),
            fused.decode_coefficients(gm_jpeg, gm_info), metadata,
            output_ct, max_display_boost)
        return packed, gm_u8, plan["hdr_cg"]

    # ------------------------------------------------------------------
    # the general path's apply, and the host engine

    def apply_gainmap(self, sdr: RawImage, gain_u8, gm_cg,
                      metadata: GainMapMetadata, output_ct, output_fmt,
                      max_display_boost: float) -> RawImage:
        """applyGainMap (jpegr.cpp:1448-1699) on ``self.device``: an SDR
        image (its planes host arrays or tensors) and a (C, mh, mw) uint8
        gain map (host array or tensor) -> the HDR output as a RawImage in
        host memory, its format following `output_ct` (`output_fmt` is not
        read, as in the JAX package).  ``_apply_inputs``, then one apply
        launch (``ops.apply.apply_gainmap_core``)."""
        del output_fmt
        a = self._apply_inputs(sdr, gain_u8, gm_cg, metadata,
                               max_display_boost)
        packed = apply_ops.apply_gainmap_core(
            a["sdr_yuv"], a["gain"], a["meta"], scale_k=a["scale_k"],
            weight=a["weight"], out_ct=ColorTransfer(output_ct),
            sdr_cg=a["sdr_cg"], hdr_cg=a["hdr_cg"],
            use_base_cg=a["use_base_cg"])
        return _output_image(packed, a["hdr_cg"], output_ct, sdr.w, sdr.h)

    def _apply_inputs(self, sdr: RawImage, gain_u8, gm_cg,
                      metadata: GainMapMetadata,
                      max_display_boost: float) -> dict:
        """The inputs of ``apply_gainmap``'s apply on ``self.device``: the
        SDR's YUV (3, H, W), the gain, its integer scale, the metadata
        arrays, the weight and the gamuts.

        A map whose aspect ratio is more than 1% off the image's is resized
        to the image on the host (``editor.resize_channels``, float64
        bicubic, jpegr.cpp:1525-1545) and uploaded again.  A map that is
        the image divided by one integer factor stays u8 with that factor;
        any other is upsampled with the float-factor IDW and stays float at
        scale 1 (the reference samples the map in float and never
        re-quantizes, gainmapmath.cpp:871-921)."""
        sdr_cg = ColorGamut(sdr.cg)
        if sdr_cg == ColorGamut.UNSPECIFIED:
            sdr_cg = ColorGamut.BT709
        hdr_cg = ColorGamut(gm_cg)
        if hdr_cg == ColorGamut.UNSPECIFIED:
            hdr_cg = sdr_cg
        gain = pixel.plane_tensor(gain_u8, self.device)
        mh, mw = gain.shape[1], gain.shape[2]
        primary_ar = sdr.w / sdr.h
        if abs(primary_ar - mw / mh) / primary_ar > 0.01:
            gain = pixel.to_device(resize_channels(gain.cpu().numpy(), sdr.w,
                                                   sdr.h), self.device)
            mh, mw = gain.shape[1], gain.shape[2]
        map_scale_factor = sdr.w / mw
        scale_k = max(1, int(round(map_scale_factor)))
        if map_scale_factor != float(scale_k) or mw * scale_k != sdr.w:
            # a device divisor: CUDA multiplies by the reciprocal of a host
            # scalar, where the JAX package divides
            div = torch.full((), 255.0, dtype=torch.float32,
                             device=self.device)
            gain = torch.clamp(idw.idw_upsample_fractional(
                gain.to(torch.float32) / div, map_scale_factor, sdr.h,
                sdr.w), 0.0, 1.0)
            scale_k = 1
        weight = apply_ops.gainmap_weight(
            max_display_boost, float(metadata.hdr_capacity_min),
            float(metadata.hdr_capacity_max))
        return {"sdr_yuv": pixel.unpack(sdr, self.device), "gain": gain,
                "scale_k": scale_k,
                "meta": apply_ops.metadata_to_arrays(metadata),
                "weight": np.float32(weight), "sdr_cg": sdr_cg,
                "hdr_cg": hdr_cg, "use_base_cg": bool(metadata.use_base_cg)}

    def decode_host(self, data: bytes, output_ct=ColorTransfer.HLG,
                    output_fmt=ImgFmt.RGBA1010102,
                    max_display_boost: float = FLT_MAX,
                    return_gainmap: bool = False):
        """The JAX package's native host decode engine (``decode_host``):
        Huffman decode, AAN float IDCT and the fused apply (IDW, gain, OETF,
        packing) in the host C++, touching no tensor and no device.

        Returns (RawImage dest, GainMapMetadata), with the gain-map image
        as a third item when `return_gainmap`.  Raises ``unsupported`` for
        exactly the streams the JAX package's raises for: an SRGB output, a
        progressive image, other component counts, a base sampled other
        than 4:4:4, 4:2:2, 4:2:0 or 4:4:0, a fractional map scale and a
        subsampled 3-channel map.  Built with the JAX package's flags, it
        gives the JAX package's bytes on the same host (``jpeg/native.py``);
        against the device decode it holds the JAX package's own gate,
        >= 55 dB a channel (its float IDCT is not libjpeg's islow)."""
        del output_fmt
        output_ct = ColorTransfer(output_ct)
        if output_ct not in _DECODE_OUTPUTS:
            raise unsupported("decode_host targets HDR outputs")
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data)
        if pinfo.progressive or gm_info.progressive:
            raise unsupported("progressive stream: use the general path")
        if pinfo.num_components != 3 or gm_info.num_components not in (1, 3):
            raise unsupported("unsupported component layout")
        base_fmt = get_output_sampling_format(pinfo)
        hf, vf = {ImgFmt.YUV444: (1, 1), ImgFmt.YUV422: (2, 1),
                  ImgFmt.YUV420: (2, 2), ImgFmt.YUV440: (1, 2)}.get(
                      base_fmt, (0, 0))
        if hf == 0:
            raise unsupported(f"unsupported base sampling {base_fmt}")
        w, h = pinfo.width, pinfo.height
        mw, mh = gm_info.width, gm_info.height
        if mw == 0 or mh == 0 or w % mw or h % mh or w // mw != h // mh:
            raise unsupported("fractional map scale: use the general path")
        if gm_info.num_components == 3 and any(
                c.h != 1 or c.v != 1 for c in gm_info.components):
            raise unsupported("subsampled multichannel gain map")
        s_cg = ColorGamut.BT709 if sdr_cg == ColorGamut.UNSPECIFIED \
            else ColorGamut(sdr_cg)
        h_cg = s_cg if ColorGamut(gm_cg) == ColorGamut.UNSPECIFIED \
            else ColorGamut(gm_cg)

        base_coeffs, base_qts, _ = decode_coefficients(primary, pinfo)
        gm_coeffs, gm_qts, _ = decode_coefficients(gm_jpeg, gm_info)
        y, u, v = (native.idct_plane(c, q)
                   for c, q in zip(base_coeffs, base_qts))
        gm_planes = [native.idct_plane(c, q)[:mh, :mw]
                     for c, q in zip(gm_coeffs, gm_qts)]
        # an RGB-coded map is kept planar, so the apply gathers u8 rows
        gm_u8 = gm_planes[0] if len(gm_planes) == 1 \
            else native.ycbcr_to_rgb_planar(*gm_planes)
        weight = apply_ops.gainmap_weight(
            max_display_boost, float(metadata.hdr_capacity_min),
            float(metadata.hdr_capacity_max))
        # the C++ layout: [gamma, min, max, off_sdr, off_hdr], 3 each
        meta15 = np.concatenate([np.asarray(getattr(metadata, f), np.float32)
                                 for f in ("gamma", "min_content_boost",
                                           "max_content_boost", "offset_sdr",
                                           "offset_hdr")])
        gamut_m = colors.gamut_conversion_matrix(h_cg, s_cg)
        packed = native.apply_gainmap_host(
            y, u, v, hf, vf, w, h, gm_u8, w // mw, meta15, weight,
            {ColorTransfer.LINEAR: 0, ColorTransfer.HLG: 1,
             ColorTransfer.PQ: 2}[output_ct],
            None if np.allclose(gamut_m, np.eye(3)) else gamut_m,
            gamut_pre=not bool(metadata.use_base_cg),
            gm_planar=len(gm_planes) == 3)
        if output_ct == ColorTransfer.LINEAR:
            packed = packed[..., None].view(np.uint16).reshape(h, w, 4)
        dest = _output_image(packed, h_cg, output_ct, w, h)
        if not return_gainmap:
            return dest, metadata
        gm_img = RawImage(
            ImgFmt.YUV400 if gm_u8.ndim == 2 else ImgFmt.RGB888,
            ColorGamut(gm_cg), ColorTransfer.UNSPECIFIED, ColorRange.FULL,
            mw, mh, [gm_u8 if gm_u8.ndim == 2 else
                     np.ascontiguousarray(np.moveaxis(gm_u8, 0, -1))])
        return dest, metadata, gm_img

    # ------------------------------------------------------------------
    # device-resident decode: per image, batched, microbatched

    def decode_to_device(self, data: bytes, output_ct=ColorTransfer.HLG,
                         max_display_boost: float = FLT_MAX, effects=None,
                         microbatch: bool | None = None):
        """Decode with the result left on ``self.device``: (packed output
        tensor, GainMapMetadata), the output (H, W) int32 RGBA1010102
        patterns or (H, W, 4) int16 RGBAF16 patterns (ops/pixel.py).

        By default concurrent callers are coalesced into
        ``decode_to_device_batch`` dispatches (the JAX package's serving
        default; a lone caller pays only the window, 4 ms).
        `microbatch=False` (or UHDR_TPU_DECODE_MICROBATCH=0) pins the
        per-image route; UHDR_TPU_DECODE_MB_WINDOW_MS and
        UHDR_TPU_DECODE_MB_K tune the window and the largest batch.

        `effects`, a queue of ``api.MirrorEffect`` / ``RotateEffect`` /
        ``CropEffect`` / ``ResizeEffect``, edits the packed output on the
        device before it is returned, on either route
        (``ops/effects_device``; the analog of the reference's GLES
        texture-side effects), the result a tensor of its own."""
        output_ct = ColorTransfer(output_ct)
        if output_ct == ColorTransfer.SRGB:
            raise unsupported("device-resident decode targets HDR outputs")
        if microbatch is None:
            microbatch = os.environ.get("UHDR_TPU_DECODE_MICROBATCH",
                                        "1") != "0"
        if microbatch:
            packed, metadata = self._decode_microbatcher().run(
                self, data, (output_ct, float(max_display_boost)))
        else:
            packed, metadata = self._decode_to_device_one(
                data, output_ct, max_display_boost)
        if effects:
            packed, _, _ = effects_device.apply_effects_packed(packed,
                                                               effects)
        return packed, metadata

    _MB_LOCK = threading.Lock()

    def _decode_microbatcher(self) -> _DeviceDecodeMicrobatcher:
        with self._MB_LOCK:
            if getattr(self, "_mb", None) is None:
                self._mb = _DeviceDecodeMicrobatcher()
        return self._mb

    def _decode_to_device_one(self, data: bytes,
                              output_ct=ColorTransfer.HLG,
                              max_display_boost: float = FLT_MAX):
        """The per-image device-resident decode (decode_to_device without
        request coalescing)."""
        output_ct = ColorTransfer(output_ct)
        if output_ct == ColorTransfer.SRGB:
            raise unsupported("device-resident decode targets HDR outputs")
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data)
        packed, _, _ = self._decode_fused_device(
            primary, pinfo, gm_jpeg, gm_info, metadata, output_ct,
            max_display_boost, sdr_cg, gm_cg)
        return packed, metadata

    def decode_to_device_batch(self, streams, output_ct=ColorTransfer.HLG,
                               max_display_boost: float = FLT_MAX,
                               mesh=None):
        """Batched ``decode_to_device``: K JPEG_R streams -> K (packed
        output on ``self.device``, GainMapMetadata) in input order.

        The streams whose fused-route signature (w, h, sampling, scale,
        gain-map channels, gamuts, application space) equals the first
        decodable stream's form the group; the others, and a group of
        fewer than two, take the per-image route.  A group member's scans
        are decoded on a thread pool as soon as the stream is parsed (the
        host C++ releases the GIL), and its upload and device stages run
        on one of the device's side streams (``fused.side_streams``, in
        turn) as soon as that decode ends, with one apply launch an image,
        so the parse, the host decodes and the card overlap.  The outputs
        equal the per-image route's bit for bit.

        With `mesh` (a ``parallel.Mesh``) and a group whose size divides
        its "data" axis, the group's images go to the data axis's devices
        in contiguous blocks, as a batch dimension sharded over that axis
        would place them; each image's output stays on its device.  Any
        other group takes ``self.device``."""
        from .parallel.batch import Mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise invalid_param(f"mesh must be a parallel.Mesh, got "
                                f"{type(mesh).__name__}")
        output_ct = ColorTransfer(output_ct)
        if output_ct == ColorTransfer.SRGB:
            raise unsupported("device-resident decode targets HDR outputs")
        cuda = (mesh.devices[0][0] if mesh else self.device).type == "cuda"
        entries: list = []
        group: dict = {}        # a host Huffman decode each -> stream index
        sig = None
        results: list = [None] * len(streams)
        with concurrent.futures.ThreadPoolExecutor(fused.HOST_THREADS) as pool:
            for i, data in enumerate(streams):
                e = self._batch_entry(data)
                entries.append(e)
                if e is None:
                    continue
                sig = sig or tuple(e["plan"].values())
                if tuple(e["plan"].values()) == sig:
                    # decoded while the next streams are parsed
                    group[pool.submit(_host_decode, e, cuda)] = i
            # a group of one takes the per-image route: its staged
            # coefficients are dropped with its future
            if len(group) >= 2:
                order = sorted(group.values())
                devices = {i: self.device for i in order}
                if mesh and len(order) % mesh.shape["data"] == 0:
                    per = len(order) // mesh.shape["data"]
                    devices = {i: mesh.devices[k // per][0]
                               for k, i in enumerate(order)}
                for i, out in self._decode_group(group, entries, output_ct,
                                                 max_display_boost,
                                                 devices).items():
                    results[i] = out
        for i, data in enumerate(streams):
            if results[i] is None:
                results[i] = self._decode_to_device_one(data, output_ct,
                                                        max_display_boost)
        return results

    def _batch_entry(self, data: bytes) -> dict | None:
        """A stream parsed for the batch, or None when the fused route does
        not take it (the per-image route then raises for it)."""
        primary, pinfo, gm_jpeg, gm_info, metadata, sdr_cg, gm_cg = \
            self._parse_jpegr(data)
        plan = self._fused_plan(pinfo, gm_info, metadata, sdr_cg, gm_cg)
        if plan is None:
            return None
        return {"primary": primary, "pinfo": pinfo, "gm_jpeg": gm_jpeg,
                "gm_info": gm_info, "metadata": metadata, "plan": plan}

    def _decode_group(self, group: dict, entries, output_ct,
                      max_display_boost, devices) -> dict:
        """The device half of a batch group: each image's upload and device
        stages on its device (`devices`: stream index -> device), on the
        next side stream of that device, as soon as its host decode (a
        future of `group`) ends, every launch on this thread; the caller's
        current stream of each device then waits for the outputs.  On the
        CPU the same stages run with no streams.  Returns {stream index:
        (packed output, metadata)}."""
        used = {dev: 0 for dev in devices.values() if dev.type == "cuda"}
        for dev in used:
            fused.prepare_device(dev)
        outs = {}
        # with UHDR_TPU_WIRE set, one wire kind a group, the first member's
        # (the JAX package's batch runs one program over the group); the
        # others take the per-image route.  Unset, nothing waits for the
        # first member: each image goes as soon as its host decode ends.
        kind = None
        if wire.coeff_wire_enabled():
            kind = min(group, key=group.get).result()[2][1]
        for f in concurrent.futures.as_completed(group):
            i = group[f]
            base, gm, coeff_wire = f.result()
            if coeff_wire is not None and coeff_wire[1] != kind:
                continue
            e = entries[i]
            dev = devices[i]
            ctx = contextlib.nullcontext()
            if dev.type == "cuda":
                streams = fused.side_streams(dev)
                ctx = torch.cuda.stream(streams[used[dev] % len(streams)])
                used[dev] += 1
            with ctx:
                packed, _ = self._decode_planned(
                    e["plan"], base, gm, e["metadata"], output_ct,
                    max_display_boost, dev, coeff_wire)
            outs[i] = (packed, e["metadata"])
        for dev in used:
            cur = torch.cuda.current_stream(dev)
            for s in fused.side_streams(dev):
                cur.wait_stream(s)
        for packed, _ in outs.values():
            if packed.device.type == "cuda":
                packed.record_stream(torch.cuda.current_stream(packed.device))
        return outs


def _output_image(packed, hdr_cg, output_ct, w: int, h: int) -> RawImage:
    """A packed HDR output (tensor on any device, or host array) as a host
    RawImage: RGBAF16 (H, W, 4) u16 patterns for LINEAR, else RGBA1010102
    (H, W) u32."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    if ColorTransfer(output_ct) == ColorTransfer.LINEAR:
        return RawImage(ImgFmt.RGBAF16, hdr_cg, output_ct, ColorRange.FULL,
                        w, h, [packed.view(np.uint16)])
    return RawImage(ImgFmt.RGBA1010102, hdr_cg, output_ct, ColorRange.FULL,
                    w, h, [packed.view(np.uint32)])


def _gainmap_image(gm_u8: torch.Tensor, gm_cg) -> RawImage:
    """A decoded (C, mh, mw) u8 gain map on its device as a host RawImage:
    YUV400 for one channel, RGB888 for three.  A 3-channel map is
    interleaved to (mh, mw, 3) on the device: the host transpose of a
    full-resolution map cost tens of ms."""
    c, mh, mw = gm_u8.shape
    plane = gm_u8.permute(1, 2, 0).contiguous().cpu().numpy()
    return RawImage(ImgFmt.YUV400 if c == 1 else ImgFmt.RGB888,
                    ColorGamut(gm_cg), ColorTransfer.UNSPECIFIED,
                    ColorRange.FULL, mw, mh,
                    [plane[..., 0] if c == 1 else plane])


def _host_decode(e: dict, stage: bool):
    """The host Huffman decode of a batch entry's two images: ((coefficient
    planes, quant tables) of the base, the same of the gain map, the
    coefficient wire or None).  With UHDR_TPU_WIRE set the planes are
    packed here into one ``pack_coeff_wire_best`` blob (a
    ``wire.pack_coeff_blob`` result); either the blob or the planes are
    staged in pinned memory when `stage` (for a copy to the card that does
    not block)."""
    out = []
    packing = wire.coeff_wire_enabled()
    for jpeg, info in ((e["primary"], e["pinfo"]), (e["gm_jpeg"],
                                                   e["gm_info"])):
        coeffs, qts, _ = fused.decode_coefficients(jpeg, info)
        if stage and not packing:
            coeffs = [pixel.pinned(c) for c in coeffs]
        out.append((coeffs, qts))
    coeff_wire = wire.pack_coeff_blob(out[0][0] + out[1][0], stage) \
        if packing else None
    return out[0], out[1], coeff_wire


def is_uhdr_image(data: bytes) -> bool:
    """is_uhdr_image (ultrahdr_api.cpp:1359-1385): the probe succeeds and a
    gain map with metadata is present.  Host parsing only."""
    try:
        primary, gm = JpegR.extract_primary_and_gainmap(data)
        if gm is None:
            return False
        pinfo = parse_jpeg(primary, parse_only=True)
        gm_info = parse_jpeg(gm, parse_only=True)
        JpegR.parse_gainmap_metadata(gm_info.iso, gm_info.xmp, pinfo.exif)
        return True
    except Exception:
        return False
