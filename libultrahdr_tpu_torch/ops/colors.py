"""Colour science primitives used by the tone map and the gain map.

Port of the parts of ``libultrahdr_tpu/ops/colors.py`` that the encodes
and the fused decode run: transfer functions, gamut and YUV matrices, the
YUV-encoding conversion matrices, luminance, clamps, the HDR float
sanitizer.  Channels lie on
the leading axis, shape (3, ...); the 3x3 conversions are unrolled float32
multiply-adds in the same order as the JAX package.  The matrices are the
reference's rounded values (gainmapmath.cpp:603-674), copied unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import ColorGamut, ColorTransfer

# nominal {SDR, HLG, PQ} peak display luminance in nits (gainmapmath.h:44-48)
SDR_WHITE_NITS = 203.0
HLG_MAX_NITS = 1000.0
PQ_MAX_NITS = 10000.0

# gain computation offsets (gainmapmath.h:549-550)
HDR_OFFSET = 1e-7
SDR_OFFSET = 1e-7

# maximum normalized pixel value for linear-HDR float intent (gainmapmath.h:577)
MAX_PIXEL_FLOAT_HDR_LINEAR = PQ_MAX_NITS / SDR_WHITE_NITS


def reference_display_peak_nits(ct) -> float:
    """getReferenceDisplayPeakLuminanceInNits (gainmapmath.cpp:18-34)."""
    return {
        ColorTransfer.LINEAR: PQ_MAX_NITS,
        ColorTransfer.HLG: HLG_MAX_NITS,
        ColorTransfer.PQ: PQ_MAX_NITS,
        ColorTransfer.SRGB: SDR_WHITE_NITS,
    }.get(ColorTransfer(ct), -1.0)


# luminance coefficients (gainmapmath.cpp:86, :157, :185)
K_SRGB = np.array([0.212639, 0.715169, 0.072192], np.float32)
K_P3 = np.array([0.2289746, 0.6917385, 0.0792869], np.float32)
K_BT2100 = np.array([0.2627, 0.677998, 0.059302], np.float32)


def luminance(rgb: torch.Tensor, coeffs) -> torch.Tensor:
    """Weighted channel sum; rgb shape (3, ...) -> (...)."""
    c = np.asarray(coeffs, np.float32)
    return float(c[0]) * rgb[0] + float(c[1]) * rgb[1] + float(c[2]) * rgb[2]


def srgb_luminance(rgb: torch.Tensor) -> torch.Tensor:
    return luminance(rgb, K_SRGB)


def p3_luminance(rgb: torch.Tensor) -> torch.Tensor:
    return luminance(rgb, K_P3)


def bt2100_luminance(rgb: torch.Tensor) -> torch.Tensor:
    return luminance(rgb, K_BT2100)


def luminance_coeffs_for_gamut(cg) -> np.ndarray:
    """getLuminanceFn (gainmapmath.cpp:1149-1162)."""
    return {ColorGamut.BT709: K_SRGB,
            ColorGamut.DISPLAY_P3: K_P3,
            ColorGamut.BT2100: K_BT2100}[ColorGamut(cg)]


def _rgb2yuv_matrix(kr: float, kg: float, kb: float) -> np.ndarray:
    cb = 2.0 * (1.0 - kb)
    cr = 2.0 * (1.0 - kr)
    return np.array([
        [kr, kg, kb],
        [-kr / cb, -kg / cb, (1.0 - kb) / cb],
        [(1.0 - kr) / cr, -kg / cr, -kb / cr],
    ], np.float32)


def _yuv2rgb_matrix(kr: float, kg: float, kb: float) -> np.ndarray:
    cb = 2.0 * (1.0 - kb)
    cr = 2.0 * (1.0 - kr)
    return np.array([
        [1.0, 0.0, cr],
        [1.0, -kb * cb / kg, -kr * cr / kg],
        [1.0, cb, 0.0],
    ], np.float32)


SRGB_RGB2YUV = _rgb2yuv_matrix(*K_SRGB)
SRGB_YUV2RGB = _yuv2rgb_matrix(*K_SRGB)
# Display-P3 luma uses BT.601 coefficients (gainmapmath.cpp:166-168)
P3_YUV_KR, P3_YUV_KG, P3_YUV_KB = 0.299, 0.587, 0.114
P3_RGB2YUV = _rgb2yuv_matrix(P3_YUV_KR, P3_YUV_KG, P3_YUV_KB)
P3_YUV2RGB = _yuv2rgb_matrix(P3_YUV_KR, P3_YUV_KG, P3_YUV_KB)
BT2100_RGB2YUV = _rgb2yuv_matrix(*K_BT2100)
BT2100_YUV2RGB = _yuv2rgb_matrix(*K_BT2100)


def apply_3x3(m, x: torch.Tensor) -> torch.Tensor:
    """(3,3) constant @ (3, ...) -> (3, ...) as unrolled f32 multiply-adds."""
    m = np.asarray(m, np.float32)
    return torch.stack([
        float(m[i, 0]) * x[0] + float(m[i, 1]) * x[1] + float(m[i, 2]) * x[2]
        for i in range(3)])


def rgb_to_yuv(rgb: torch.Tensor, matrix) -> torch.Tensor:
    return apply_3x3(matrix, rgb)


def yuv_to_rgb(yuv: torch.Tensor, matrix, clamp: bool = True
               ) -> torch.Tensor:
    """YUV->RGB, clamped to [0,1] like the reference (clampPixelFloat)
    unless `clamp` is False."""
    rgb = apply_3x3(matrix, yuv)
    return torch.clamp(rgb, 0.0, 1.0) if clamp else rgb


def rgb2yuv_matrix_for_gamut(cg) -> np.ndarray:
    """The RGB->YUV matrix of a gamut (Display-P3 with BT.601 luma)."""
    return {ColorGamut.BT709: SRGB_RGB2YUV,
            ColorGamut.DISPLAY_P3: P3_RGB2YUV,
            ColorGamut.BT2100: BT2100_RGB2YUV}[ColorGamut(cg)]


def yuv2rgb_matrix_for_gamut(cg) -> np.ndarray:
    """getYuvToRgbFn (gainmapmath.cpp:1135-1147)."""
    return {ColorGamut.BT709: SRGB_YUV2RGB,
            ColorGamut.DISPLAY_P3: P3_YUV2RGB,
            ColorGamut.BT2100: BT2100_YUV2RGB}[ColorGamut(cg)]


# ---------------------------------------------------------------------------
# transfer functions, domain/range [0, 1]

def srgb_inv_oetf(e_gamma: torch.Tensor) -> torch.Tensor:
    """sRGB EOTF, IEC 61966-2-1 Eq F.5/F.6 (gainmapmath.cpp:114-125)."""
    lo = e_gamma / 12.92
    hi = torch.pow(torch.clamp((e_gamma + 0.055) / 1.055, min=0.0), 2.4)
    return torch.where(e_gamma <= 0.04045, lo, hi)


def srgb_oetf(e: torch.Tensor) -> torch.Tensor:
    """sRGB OETF, IEC 61966-2-1 Eq F.10/F.11 (gainmapmath.cpp:140-150)."""
    lo = 12.92 * e
    hi = 1.055 * torch.pow(torch.clamp(e, min=1e-37), 1.0 / 2.4) - 0.055
    return torch.where(e <= 0.0031308, lo, hi)


_HLG_A, _HLG_B, _HLG_C = 0.17883277, 0.28466892, 0.55991073


def hlg_oetf(e: torch.Tensor) -> torch.Tensor:
    """HLG OETF, ITU-R BT.2100-2 Table 5 (gainmapmath.cpp:238-247)."""
    lo = torch.sqrt(torch.clamp(3.0 * e, min=0.0))
    hi = _HLG_A * torch.log(torch.clamp(12.0 * e - _HLG_B, min=1e-37)) \
        + _HLG_C
    return torch.where(e <= 1.0 / 12.0, lo, hi)


def hlg_inv_oetf(e_gamma: torch.Tensor) -> torch.Tensor:
    """HLG inverse OETF (gainmapmath.cpp:262-270)."""
    lo = torch.square(e_gamma) / 3.0
    hi = (torch.exp((e_gamma - _HLG_C) / _HLG_A) + _HLG_B) / 12.0
    return torch.where(e_gamma <= 0.5, lo, hi)


_OOTF_GAMMA = 1.2  # BT.2100-2 Table 5 Note 5f for a 1000-nit display


def hlg_ootf(rgb: torch.Tensor, lum_coeffs) -> torch.Tensor:
    """HLG reference OOTF (gainmapmath.cpp:288-291).  The codec never runs
    it (getOotfFn binds ``hlg_ootf_approx``); kept, as in the JAX package,
    for the reference's exported math surface."""
    y = luminance(rgb, lum_coeffs)
    return rgb * torch.pow(torch.clamp(y, min=1e-37), _OOTF_GAMMA - 1.0)


def hlg_inverse_ootf(rgb: torch.Tensor, lum_coeffs) -> torch.Tensor:
    """HLG inverse OOTF (gainmapmath.cpp:301-305)."""
    y = luminance(rgb, lum_coeffs)
    return rgb * torch.pow(torch.clamp(y, min=1e-37),
                           (1.0 / _OOTF_GAMMA) - 1.0)


def hlg_ootf_approx(rgb: torch.Tensor) -> torch.Tensor:
    """hlgOotfApprox (gainmapmath.cpp:293-295): per-channel pow(1.2), what
    getOotfFn(UHDR_CT_HLG) returns (gainmapmath.cpp:1191-1192)."""
    return torch.pow(torch.clamp(rgb, min=0.0), _OOTF_GAMMA)


_PQ_M1 = 2610.0 / 16384.0
_PQ_M2 = 2523.0 / 4096.0 * 128.0
_PQ_C1 = 3424.0 / 4096.0
_PQ_C2 = 2413.0 / 4096.0 * 32.0
_PQ_C3 = 2392.0 / 4096.0 * 32.0


def pq_oetf(e: torch.Tensor) -> torch.Tensor:
    """PQ OETF, ITU-R BT.2100-2 Table 4 (gainmapmath.cpp:313-318)."""
    ep = torch.pow(torch.clamp(e, min=0.0), _PQ_M1)
    v = torch.pow((_PQ_C1 + _PQ_C2 * ep) / (1.0 + _PQ_C3 * ep), _PQ_M2)
    return torch.where(e <= 0.0, 0.0, v)


def pq_inv_oetf(e_gamma: torch.Tensor) -> torch.Tensor:
    """PQ inverse OETF (gainmapmath.cpp:333-336)."""
    val = torch.pow(torch.clamp(e_gamma, min=0.0), 1.0 / _PQ_M2)
    num = torch.clamp(val - _PQ_C1, min=0.0)
    den = _PQ_C2 - _PQ_C3 * val
    return torch.pow(num / den, 1.0 / _PQ_M1)


def inv_oetf(e_gamma: torch.Tensor, ct) -> torch.Tensor:
    """getInverseOetfFn (gainmapmath.cpp:1188-1203). LINEAR clamps to [0,1]."""
    ct = ColorTransfer(ct)
    if ct == ColorTransfer.LINEAR:
        return torch.clamp(e_gamma, 0.0, 1.0)
    if ct == ColorTransfer.HLG:
        return hlg_inv_oetf(e_gamma)
    if ct == ColorTransfer.PQ:
        return pq_inv_oetf(e_gamma)
    if ct == ColorTransfer.SRGB:
        return srgb_inv_oetf(e_gamma)
    raise ValueError(f"no inverse oetf for {ct}")


def ootf(rgb: torch.Tensor, ct, lum_coeffs=None) -> torch.Tensor:
    """getOotfFn (gainmapmath.cpp:1187-1201): HLG applies the per-channel
    OOTF approximation, the others are identity.  `lum_coeffs` is accepted
    for the JAX package's signature and not read, like hlgOotfApprox's
    unused luminance argument."""
    del lum_coeffs
    if ColorTransfer(ct) == ColorTransfer.HLG:
        return hlg_ootf_approx(rgb)
    return rgb


# ---------------------------------------------------------------------------
# RGB gamut conversion matrices (gainmapmath.cpp:603-615)

BT709_TO_P3 = np.array([[0.822462, 0.177537, 0.000001],
                        [0.033194, 0.966807, -0.000001],
                        [0.017083, 0.072398, 0.91052]], np.float32)
BT709_TO_BT2100 = np.array([[0.627404, 0.329282, 0.043314],
                            [0.069097, 0.919541, 0.011362],
                            [0.016392, 0.088013, 0.895595]], np.float32)
P3_TO_BT709 = np.array([[1.22494, -0.22494, 0.0],
                        [-0.042057, 1.042057, 0.0],
                        [-0.019638, -0.078636, 1.098274]], np.float32)
P3_TO_BT2100 = np.array([[0.753833, 0.198597, 0.04757],
                         [0.045744, 0.941777, 0.012479],
                         [-0.00121, 0.017601, 0.983608]], np.float32)
BT2100_TO_BT709 = np.array([[1.660491, -0.587641, -0.07285],
                            [-0.124551, 1.1329, -0.008349],
                            [-0.018151, -0.100579, 1.11873]], np.float32)
BT2100_TO_P3 = np.array([[1.343578, -0.282179, -0.061399],
                         [-0.065298, 1.075788, -0.01049],
                         [0.002822, -0.019598, 1.016777]], np.float32)

_IDENTITY3 = np.eye(3, dtype=np.float32)


def gamut_conversion_matrix(dst_cg, src_cg) -> np.ndarray:
    """getGamutConversionFn (gainmapmath.cpp:1087-1133) as a matrix lookup."""
    dst, src = ColorGamut(dst_cg), ColorGamut(src_cg)
    if dst == src:
        return _IDENTITY3
    return {
        (ColorGamut.DISPLAY_P3, ColorGamut.BT709): BT709_TO_P3,
        (ColorGamut.BT2100, ColorGamut.BT709): BT709_TO_BT2100,
        (ColorGamut.BT709, ColorGamut.DISPLAY_P3): P3_TO_BT709,
        (ColorGamut.BT2100, ColorGamut.DISPLAY_P3): P3_TO_BT2100,
        (ColorGamut.BT709, ColorGamut.BT2100): BT2100_TO_BT709,
        (ColorGamut.DISPLAY_P3, ColorGamut.BT2100): BT2100_TO_P3,
    }[(dst, src)]


def convert_gamut(rgb: torch.Tensor, matrix) -> torch.Tensor:
    return apply_3x3(matrix, rgb)


# ---------------------------------------------------------------------------
# YUV-space gamut ("encoding") conversion matrices (gainmapmath.cpp:638-674)

YUV_BT709_TO_BT601 = np.array([[1.0, 0.101579, 0.196076],
                               [0.0, 0.989854, -0.110653],
                               [0.0, -0.072453, 0.983398]], np.float32)
YUV_BT709_TO_BT2100 = np.array([[1.0, -0.016969, 0.096312],
                                [0.0, 0.995306, -0.051192],
                                [0.0, 0.011507, 1.002637]], np.float32)
YUV_BT601_TO_BT709 = np.array([[1.0, -0.118188, -0.212685],
                               [0.0, 1.018640, 0.114618],
                               [0.0, 0.075049, 1.025327]], np.float32)
YUV_BT601_TO_BT2100 = np.array([[1.0, -0.128245, -0.115879],
                                [0.0, 1.010016, 0.061592],
                                [0.0, 0.086969, 1.029350]], np.float32)
YUV_BT2100_TO_BT709 = np.array([[1.0, 0.018149, -0.095132],
                                [0.0, 1.004123, 0.051267],
                                [0.0, -0.011524, 0.996782]], np.float32)
YUV_BT2100_TO_BT601 = np.array([[1.0, 0.117887, 0.105521],
                                [0.0, 0.995211, -0.059549],
                                [0.0, -0.084085, 0.976518]], np.float32)


def yuv_encoding_conversion_matrix(src_cg, dst_cg):
    """JpegR::convertYuv coefficient table (jpegr.cpp:430-513); None for
    the identity.  Display-P3 uses the BT.601 YUV encoding."""
    src, dst = ColorGamut(src_cg), ColorGamut(dst_cg)
    if src == dst:
        return None
    return {
        (ColorGamut.BT709, ColorGamut.DISPLAY_P3): YUV_BT709_TO_BT601,
        (ColorGamut.BT709, ColorGamut.BT2100): YUV_BT709_TO_BT2100,
        (ColorGamut.DISPLAY_P3, ColorGamut.BT709): YUV_BT601_TO_BT709,
        (ColorGamut.DISPLAY_P3, ColorGamut.BT2100): YUV_BT601_TO_BT2100,
        (ColorGamut.BT2100, ColorGamut.BT709): YUV_BT2100_TO_BT709,
        (ColorGamut.BT2100, ColorGamut.DISPLAY_P3): YUV_BT2100_TO_BT601,
    }[(src, dst)]


def clip_negatives(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0)


def clamp_pixel_float(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def clamp_pixel_float_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, MAX_PIXEL_FLOAT_HDR_LINEAR)


def sanitize_pixel(x: torch.Tensor) -> torch.Tensor:
    """sanitizePixel (gainmapmath.h:585-590): nan->0, +inf->max, -inf->0,
    finite clamped to [0, 10000/203]."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0,
                         posinf=MAX_PIXEL_FLOAT_HDR_LINEAR, neginf=0.0)
    return torch.clamp(x, 0.0, MAX_PIXEL_FLOAT_HDR_LINEAR)
