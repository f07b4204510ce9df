"""AGTM: gain-map generation from SMPTE 2094-50 dynamic tone-map metadata.

Port of ``libultrahdr_tpu/agtm.py`` (after the reference's generateGainMap,
lib/src/agtm.cpp:37-204).  The metadata model, the monotone PCHIP
(Fritsch-Carlson) and the 1024-entry log2-gain LUT of each rule are host
numpy, copied as they are.  The per-pixel pass (the component mix, the LUT
lookup, the headroom blend and the affine u8 quantisation; an elementwise
XLA program in the JAX package, no Pallas kernel) is plain PyTorch on the
caller's device, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .errors import invalid_param
from .jpegr import resolve_device
from .ops import colors, pixel
from .ops.lut_parity import GAIN_FACTOR_N
from .types import (ColorGamut, GainMapMetadata, ImgFmt, RGB_FORMATS,
                    RawImage)

N_LUT = GAIN_FACTOR_N  # kGainFactorNumEntries (gainmapmath.h:450)


@dataclasses.dataclass
class ComponentMix:
    """smpte2094_50::ComponentMix: weights picking the curve input."""

    rgb: tuple = (0.0, 0.0, 0.0)
    component: float = 0.0   # luma weight
    max: float = 0.0
    min: float = 0.0


@dataclasses.dataclass
class GainCurveRule:
    """One tone-mapping rule: target headroom + mix + PCHIP control points."""

    alternate_hdr_headroom_log2: float
    mix: ComponentMix
    curve: list   # [(x, y_log2gain), ...] with x in [0,1], increasing


@dataclasses.dataclass
class DynamicMetadata:
    """smpte2094_50::DynamicMetadata (the subset agtm.cpp consumes)."""

    baseline_hdr_headroom_log2: float
    rules: list = dataclasses.field(default_factory=list)


def pchip_coefficients(x: np.ndarray, y: np.ndarray):
    """Fritsch-Carlson monotone cubic Hermite slopes."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    if n < 2 or np.any(np.diff(x) <= 0):
        raise invalid_param("gain curve needs >= 2 strictly increasing x")
    h = np.diff(x)
    delta = np.diff(y) / h
    d = np.zeros(n)
    if n == 2:
        d[:] = delta[0]
        return d
    # interior slopes: weighted harmonic mean where deltas share sign
    for k in range(1, n - 1):
        if delta[k - 1] * delta[k] <= 0:
            d[k] = 0.0
        else:
            w1 = 2 * h[k] + h[k - 1]
            w2 = h[k] + 2 * h[k - 1]
            d[k] = (w1 + w2) / (w1 / delta[k - 1] + w2 / delta[k])

    # endpoint slopes (shape-preserving one-sided)
    def _end(h0, h1, d0, d1):
        s = ((2 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
        if s * d0 <= 0:
            return 0.0
        if d0 * d1 < 0 and abs(s) > 3 * abs(d0):
            return 3 * d0
        return s
    d[0] = _end(h[0], h[1], delta[0], delta[1])
    d[-1] = _end(h[-1], h[-2], delta[-1], delta[-2])
    return d


def pchip_eval(x: np.ndarray, y: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Evaluate the monotone PCHIP through (x, y) at points q (clamped)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = pchip_coefficients(x, y)
    q = np.clip(q, x[0], x[-1])
    i = np.clip(np.searchsorted(x, q, side="right") - 1, 0, len(x) - 2)
    h = x[i + 1] - x[i]
    t = (q - x[i]) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t * t * (3 - 2 * t)
    h11 = t * t * (t - 1)
    return (h00 * y[i] + h10 * h * d[i] + h01 * y[i + 1] + h11 * h * d[i + 1])


def _rule_lut(rule: GainCurveRule) -> np.ndarray:
    xs = np.array([c[0] for c in rule.curve])
    ys = np.array([c[1] for c in rule.curve])
    grid = np.arange(N_LUT, dtype=np.float64) / (N_LUT - 1)
    return pchip_eval(xs, ys, grid).astype(np.float32)


def _agtm_pixels(vals: torch.Tensor, lut0: torch.Tensor, lut1: torch.Tensor,
                 mix0: np.ndarray, mix1: np.ndarray, w01: float,
                 lo: torch.Tensor, hi: torch.Tensor, *, fmt: ImgFmt,
                 cg: ColorGamut) -> torch.Tensor:
    """The per-pixel AGTM (agtm.cpp:25-35 applyMix + :150-195 loop) on
    vals' device: (3, H, W) unpacked gamma values -> (3, H, W) u8 map.

    mix{0,1}: (6,) f32 host weights [r, g, b, luma, max, min]; w01 the
    float32 weight toward lut1; lo, hi: (3, 1, 1) f32 log2 bounds per
    channel on the device.  The JAX program takes the same values as traced
    operands; the weights' branches are decided here on the host, and its
    map gamma is always 1 (generate_gainmap_agtm writes it so), which makes
    its pow branch the identity."""
    rgb = vals if ImgFmt(fmt) in RGB_FORMATS else colors.yuv_to_rgb(
        vals, colors.yuv2rgb_matrix_for_gamut(cg))
    luma = colors.luminance(rgb, colors.luminance_coeffs_for_gamut(cg))

    def mixed(mix):
        if np.sum(mix, dtype=np.float32) == 0.0:
            return luma
        m = [float(v) for v in mix]
        x = m[0] * rgb[0] + m[1] * rgb[1] + m[2] * rgb[2] + m[3] * luma
        if m[4] > 0.0:
            x = x + m[4] * torch.amax(rgb, dim=0)
        if m[5] > 0.0:
            x = x + m[5] * torch.amin(rgb, dim=0)
        return torch.clamp(x, 0.0, 1.0)

    def lookup(lut, mix):
        # the float -> int32 cast truncates toward zero, then the clamp
        idx = (mixed(mix) * float(N_LUT - 1) + 0.5).to(torch.int32)
        return lut[torch.clamp(idx, 0, N_LUT - 1).long()]

    one_minus = float(np.float32(1.0) - np.float32(w01))
    log_gain = one_minus * lookup(lut0, mix0) \
        + float(np.float32(w01)) * lookup(lut1, mix1)
    mapped = (log_gain[None] - lo) / (hi - lo)
    return torch.clamp(mapped * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def generate_gainmap_agtm(image: RawImage, metadata: DynamicMetadata,
                          hdr_capacity_max: float = -1.0, *,
                          device="cuda"):
    """generateGainMap (agtm.cpp:37-204): a full-resolution RGB888 gain map
    (a host RawImage) and its gain-map metadata from dynamic tone-mapping
    rules, the pixels computed on `device` (the card unless the caller asks
    for the CPU; a CUDA request without a GPU raises)."""
    dev = resolve_device(device)
    evaluators = [dict(H=metadata.baseline_hdr_headroom_log2,
                       lut=np.zeros(N_LUT, np.float32),
                       mix=np.zeros(6, np.float32), baseline=True)]
    for rule in metadata.rules:
        m = rule.mix
        evaluators.append(dict(
            H=rule.alternate_hdr_headroom_log2, lut=_rule_lut(rule),
            mix=np.array([*m.rgb, m.component, m.max, m.min], np.float32),
            baseline=False))
    evaluators.sort(key=lambda e: e["H"])

    if hdr_capacity_max < 0.0:
        hdr_capacity_max = float(np.exp2(max(e["H"] for e in evaluators)))

    target_h = float(np.clip(np.log2(hdr_capacity_max),
                             evaluators[0]["H"], evaluators[-1]["H"]))
    idx = 0
    for i in range(len(evaluators) - 1):
        if evaluators[i]["H"] <= target_h <= evaluators[i + 1]["H"]:
            idx = i
            break
    if len(evaluators) > 1:
        ev0, ev1 = evaluators[idx], evaluators[idx + 1]
        w01 = 0.0 if ev1["H"] == ev0["H"] else \
            (target_h - ev0["H"]) / (ev1["H"] - ev0["H"])
    else:
        ev0 = ev1 = evaluators[0]
        w01 = 0.0

    md = GainMapMetadata()
    md.hdr_capacity_min = 1.0
    md.hdr_capacity_max = hdr_capacity_max
    md.min_content_boost[:] = 1.0
    md.max_content_boost[:] = hdr_capacity_max
    md.gamma[:] = 1.0
    md.offset_sdr[:] = 0.0
    md.offset_hdr[:] = 0.0

    lo = np.log2(np.asarray(md.min_content_boost, np.float32))
    hi = np.log2(np.asarray(md.max_content_boost, np.float32))
    hi = np.where(np.abs(hi - lo) < np.finfo(np.float32).eps, hi + 1e-4, hi)

    def on_dev(a):
        return pixel.to_device(np.ascontiguousarray(a, np.float32), dev)

    # a baseline evaluator's zero LUT and zero mix give log-gain 0 whatever
    # the pixel, as agtm.cpp's is_baseline short-circuit does
    gm = _agtm_pixels(
        pixel.unpack(image, dev), on_dev(ev0["lut"]), on_dev(ev1["lut"]),
        ev0["mix"], ev1["mix"], w01, on_dev(lo.reshape(3, 1, 1)),
        on_dev(hi.reshape(3, 1, 1)), fmt=ImgFmt(image.fmt),
        cg=ColorGamut(image.cg))
    gm_np = gm.permute(1, 2, 0).contiguous().cpu().numpy()
    gm_img = RawImage(ImgFmt.RGB888, image.cg, image.ct, image.range,
                      image.w, image.h, [gm_np])
    return gm_img, md
