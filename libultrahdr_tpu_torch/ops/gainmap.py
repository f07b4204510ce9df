"""Gain map generation: log2(HDR/SDR) quantised to u8, one-pass and
two-pass.

Port of ``libultrahdr_tpu/ops/gainmap.py``, after JpegR::generateGainMap
(jpegr.cpp:524-1051) and the per-pixel primitives encodeGain / computeGain
/ affineMapGain (gainmapmath.cpp:753-789).  Inputs are the unpacked
(3, H, W) float32 SDR and HDR gamma values; output is the
(C, H//scale, W//scale) u8 gain map, C = 3 per-channel or 1
maxRGB/luminance.  The two-pass (BEST_QUALITY) map is a float pass with a
per-channel min/max reduction on the device, the boost bounds resolved on
the host from those 2C floats (``resolve_boost_bounds``), then an affine
quantisation on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..types import RGB_FORMATS, ColorGamut, ColorTransfer, ImgFmt
from . import colors, pixel
from .lut_parity import SRGB_INV_OETF_N, lut_quantize


# two-pass gain clamp bounds (jpegr.cpp:965-969)
GAIN_LOG2_MIN = -14.3
GAIN_LOG2_MAX = 15.6
# dark-pixel gain cap of computeGain (gainmapmath.cpp:773-782)
DARK_SDR_THRESHOLD = 2.0 / 255.0
DARK_GAIN_CAP = 2.3


class GainmapPrep(NamedTuple):
    """Linear-light SDR/HDR values at gain map resolution."""

    sdr_rgb: torch.Tensor  # (3, mh, mw) linear SDR, [0,1] scale
    hdr_rgb: torch.Tensor  # (3, mh, mw) linear HDR, [0,1] scale
    hdr_sample_to_nits: float


def _prep(sdr_vals, hdr_vals, sdr_fmt, hdr_fmt, sdr_cg, hdr_cg, ct,
          scale: int, sdr_is_601: bool, use_base_cg: bool) -> GainmapPrep:
    """Box-downsample by `scale`, YUV->RGB, LUT-grid sRGB inverse OETF for
    SDR, inverse OETF + OOTF for HDR, gamut conversion to the common space,
    clip negatives (jpegr.cpp:746-788)."""
    sdr_ds = pixel.box_downsample(sdr_vals, scale)
    hdr_ds = pixel.box_downsample(hdr_vals, scale)

    if ImgFmt(sdr_fmt) in RGB_FORMATS:
        sdr_rgb_gamma = sdr_ds
    else:
        m = colors.P3_YUV2RGB if sdr_is_601 \
            else colors.yuv2rgb_matrix_for_gamut(sdr_cg)
        sdr_rgb_gamma = colors.yuv_to_rgb(sdr_ds, m)
    sdr_rgb = colors.srgb_inv_oetf(
        lut_quantize(torch.clamp(sdr_rgb_gamma, 0.0, 1.0), SRGB_INV_OETF_N))

    if ImgFmt(hdr_fmt) in RGB_FORMATS:
        hdr_rgb_gamma = hdr_ds
    else:
        hdr_rgb_gamma = colors.yuv_to_rgb(
            hdr_ds, colors.yuv2rgb_matrix_for_gamut(hdr_cg))
    hdr_rgb = colors.ootf(colors.inv_oetf(hdr_rgb_gamma, ct), ct)

    # gamut conversion direction (jpegr.cpp:600-646): with use_base_cg the
    # HDR goes into the SDR gamut, else the SDR into the HDR gamut
    if ColorGamut(sdr_cg) != ColorGamut(hdr_cg):
        if use_base_cg:
            hdr_rgb = colors.convert_gamut(
                hdr_rgb, colors.gamut_conversion_matrix(sdr_cg, hdr_cg))
        else:
            sdr_rgb = colors.convert_gamut(
                sdr_rgb, colors.gamut_conversion_matrix(hdr_cg, sdr_cg))
    sdr_rgb = colors.clip_negatives(sdr_rgb)
    hdr_rgb = colors.clip_negatives(hdr_rgb)

    hdr_white_nits = colors.reference_display_peak_nits(ct)
    to_nits = colors.SDR_WHITE_NITS \
        if ColorTransfer(ct) == ColorTransfer.LINEAR else hdr_white_nits
    return GainmapPrep(sdr_rgb, hdr_rgb, to_nits)


def _nits_pair(prep: GainmapPrep, multichannel: bool, use_luminance: bool,
               sdr_cg):
    """SDR/HDR nits: per channel (3,mh,mw) or maxRGB/luma (1,mh,mw)."""
    if multichannel:
        return (prep.sdr_rgb * colors.SDR_WHITE_NITS,
                prep.hdr_rgb * prep.hdr_sample_to_nits)
    if use_luminance:
        lum = colors.luminance_coeffs_for_gamut(sdr_cg)
        s = colors.luminance(prep.sdr_rgb, lum)
        h = colors.luminance(prep.hdr_rgb, lum)
    else:
        s = torch.amax(prep.sdr_rgb, dim=0)
        h = torch.amax(prep.hdr_rgb, dim=0)
    return ((s * colors.SDR_WHITE_NITS)[None],
            (h * prep.hdr_sample_to_nits)[None])


def encode_gain(sdr_nits: torch.Tensor, hdr_nits: torch.Tensor,
                min_boost: float, max_boost: float,
                gamma: float) -> torch.Tensor:
    """encodeGain (gainmapmath.cpp:753-771): u8 = trunc(pow(norm, gamma) *
    255), norm the log2 gain between the boosts."""
    f32 = dict(dtype=torch.float32, device=sdr_nits.device)
    lo_b = torch.full((), min_boost, **f32)
    hi_b = torch.full((), max_boost, **f32)
    gain = torch.where(sdr_nits > 0.0,
                       hdr_nits / torch.clamp(sdr_nits, min=1e-37), 1.0)
    gain = torch.minimum(torch.maximum(gain, lo_b), hi_b)
    log2min, log2max = torch.log2(lo_b), torch.log2(hi_b)
    norm = (torch.log2(gain) - log2min) / (log2max - log2min)
    norm_g = torch.pow(norm, torch.full((), gamma, **f32))
    return torch.clamp(norm_g * 255.0, 0.0, 255.0).to(torch.uint8)


def folded_gain_scale(max_boost: float, gamma: float) -> np.float32:
    """The one float32 multiplier of log(gain) that XLA's algebraic
    simplifier leaves of ``encode_gain`` when min_boost (1), max_boost and
    gamma are compile-time constants, as in every fused encode of the JAX
    package.  ``jnp.log2(x)`` is ``log(x) / log(2)``; log2(1) folds to 0 and
    the subtractions of it go; each divide by a constant becomes a multiply
    by its float32 reciprocal; ``pow(norm, 1)`` goes; then the constant
    multiplies reassociate into one:

        gamma 1:  log(g) * ((1/ln2) * ((1/log2max) * 255))
        else:     log(g) * ((1/ln2) * (1/log2max)), then the power, * 255

    with ln2 = log(2) and log2max = log(max_boost) / ln2 folded in float32
    (HLG: 159.919785 and 0.627136469, PQ: 65.4326935 and 0.2565988)."""
    f = np.float32
    one = f(1.0)
    ln2 = f(math.log(2.0))
    scale = one / (f(math.log(float(f(max_boost)))) / ln2)
    if f(gamma) == one:
        scale = scale * f(255.0)
    return (one / ln2) * scale


def encode_gain_folded(sdr_nits: torch.Tensor, hdr_nits: torch.Tensor,
                       max_boost: float, gamma: float) -> torch.Tensor:
    """``encode_gain`` with min_boost 1 as the JAX package's compiled fused
    programs compute it: log(gain) times ``folded_gain_scale``, then for
    gamma != 1 the power as XLA simplifies it (x*x for 2, x*(x*x) for 3)
    and * 255.  A clipped HLG sample (gain == max_boost, gamma 1) codes
    254 (254.99998 truncated) where the unfolded form writes 255."""
    f32 = dict(dtype=torch.float32, device=sdr_nits.device)
    gain = torch.where(sdr_nits > 0.0,
                       hdr_nits / torch.clamp(sdr_nits, min=1e-37), 1.0)
    gain = torch.minimum(torch.maximum(gain, torch.ones((), **f32)),
                         torch.full((), max_boost, **f32))
    x = torch.log(gain) * folded_gain_scale(max_boost, gamma)
    g = np.float32(gamma)
    if g != 1.0:
        x = (x * x if g == 2.0 else x * (x * x) if g == 3.0
             else torch.pow(x, float(g))) * 255.0
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def generate_gainmap_onepass(sdr_vals, hdr_vals, *, sdr_fmt, hdr_fmt,
                             sdr_cg, hdr_cg, ct, scale: int,
                             multichannel: bool, gamma: float,
                             use_luminance: bool, sdr_is_601: bool,
                             use_base_cg: bool, max_boost: float,
                             folded: bool = False) -> torch.Tensor:
    """One-pass (REALTIME) gain map (jpegr.cpp:712-828): the metadata is
    fixed beforehand (max_content_boost = hdr_white / 203 passed in as
    `max_boost`, min 1).  `folded` quantises as the JAX package's fused
    programs do, which compile the boosts and gamma in as constants
    (``encode_gain_folded``); the general path's map, like its JAX twin's,
    is unfolded.  Returns (C, mh, mw) uint8."""
    prep = _prep(sdr_vals, hdr_vals, sdr_fmt, hdr_fmt, sdr_cg, hdr_cg, ct,
                 scale, sdr_is_601, use_base_cg)
    sdr_nits, hdr_nits = _nits_pair(prep, multichannel, use_luminance,
                                    sdr_cg)
    if folded:
        return encode_gain_folded(sdr_nits, hdr_nits, max_boost, gamma)
    return encode_gain(sdr_nits, hdr_nits, 1.0, max_boost, gamma)


def compute_gain(sdr_nits: torch.Tensor,
                 hdr_nits: torch.Tensor) -> torch.Tensor:
    """computeGain (gainmapmath.cpp:773-782): log2 ratio with offsets and
    the dark-pixel 2.3 cap (the reference compares the nits value against
    2/255, matched verbatim)."""
    g = torch.log2((hdr_nits + colors.HDR_OFFSET)
                   / (sdr_nits + colors.SDR_OFFSET))
    return torch.where(sdr_nits < DARK_SDR_THRESHOLD,
                       torch.clamp(g, max=DARK_GAIN_CAP), g)


def affine_map_gain(gainlog2: torch.Tensor, mingainlog2: torch.Tensor,
                    maxgainlog2: torch.Tensor, gamma: float) -> torch.Tensor:
    """affineMapGain (gainmapmath.cpp:784-789): normalize, gamma, quantize
    with +0.5 rounding."""
    mapped = (gainlog2 - mingainlog2) / (maxgainlog2 - mingainlog2)
    if np.float32(gamma) != 1.0:
        mapped = torch.pow(torch.clamp(mapped, min=0.0), torch.full(
            (), gamma, dtype=torch.float32, device=mapped.device))
    return torch.clamp(mapped * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def gainmap_float_pass(sdr_vals, hdr_vals, *, sdr_fmt, hdr_fmt, sdr_cg,
                       hdr_cg, ct, scale: int, multichannel: bool,
                       use_luminance: bool, sdr_is_601: bool,
                       use_base_cg: bool):
    """Two-pass pass 1 (jpegr.cpp:859-960): float log2 gains and their
    per-channel min/max.  Returns (gains (C,mh,mw) f32, min (C,), max
    (C,)), all on the inputs' device."""
    prep = _prep(sdr_vals, hdr_vals, sdr_fmt, hdr_fmt, sdr_cg, hdr_cg, ct,
                 scale, sdr_is_601, use_base_cg)
    sdr_nits, hdr_nits = _nits_pair(prep, multichannel, use_luminance,
                                    sdr_cg)
    gains = compute_gain(sdr_nits, hdr_nits)
    # thread-local seeds 127 / -128 (jpegr.cpp:843-845) bound the reduction
    gmin = torch.clamp(torch.amin(gains, dim=(1, 2)), max=127.0)
    gmax = torch.clamp(torch.amax(gains, dim=(1, 2)), min=-128.0)
    return gains, gmin, gmax


def resolve_boost_bounds(gmin: np.ndarray, gmax: np.ndarray, *,
                         multichannel: bool, min_content_boost: float | None,
                         max_content_boost: float | None,
                         merge_channels: bool) -> tuple[np.ndarray, np.ndarray]:
    """Host-side metadata resolution between the passes (jpegr.cpp:947-981):
    optional channel merge (XMP mode), clamp to [-14.3, 15.6], apply user
    suggestions, epsilon-separate equal bounds."""
    n = 3 if multichannel else 1
    gmin = np.array(gmin[:n], np.float32)
    gmax = np.array(gmax[:n], np.float32)
    if merge_channels:
        gmin[:] = gmin.min()
        gmax[:] = gmax.max()
    gmin = np.clip(gmin, GAIN_LOG2_MIN, GAIN_LOG2_MAX)
    gmax = np.clip(gmax, GAIN_LOG2_MIN, GAIN_LOG2_MAX)
    if max_content_boost is not None:
        gmax = np.minimum(gmax, np.float32(np.log2(max_content_boost)))
    if min_content_boost is not None:
        gmin = np.maximum(gmin, np.float32(np.log2(min_content_boost)))
    eps = np.finfo(np.float32).eps
    gmax = np.where(np.abs(gmax - gmin) < eps, gmax + np.float32(0.1), gmax)
    return gmin, gmax


def encode_gainmap_twopass(gains: torch.Tensor, gmin: np.ndarray,
                           gmax: np.ndarray, gamma: float) -> torch.Tensor:
    """Two-pass pass 2 (encodeMap, jpegr.cpp:983-1027): affine quantization
    of the (C, mh, mw) gains with the resolved per-channel bounds (host
    float32 arrays)."""
    c = gains.shape[0]

    def bound(b):
        return pixel.to_device(np.asarray(b, np.float32)[:c].reshape(
            c, 1, 1), gains.device)
    return affine_map_gain(gains, bound(gmin), bound(gmax), gamma)
