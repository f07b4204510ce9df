"""The pixel stages of libultrahdr's encode and decode, written plainly.

Every function takes and returns torch tensors in the float `dtype` it is
given: float64 for the reference, bfloat16 for the control.  Channels lie
on the leading axis.  The stages follow libultrahdr 1.x (jpegr.cpp,
gainmapmath.cpp) as the port states them:

- encode API-0: P010 unpack, tone map (Reinhard on maxRGB, BT.2100 ->
  Display-P3, sRGB OETF, BT.601 YUV, 4:2:0 by 2x2 means), the one-pass
  gain map on maxRGB with its quantisation to u8;
- encode API-1 BEST_QUALITY: the two-pass gain map (float log2 gains, their
  per-channel bounds, an affine quantisation);
- decode: YUV -> RGB, sRGB EOTF, gain application with the reference's LUT
  grids, HLG or PQ output packed as 10-bit codes; Shepard's IDW upsampling
  of a map at an integer scale.

The one departure from gainmapmath.cpp is the one the port documents (its
F3): the one-pass map's quantisation multiplies ln(gain) by one float32
constant (``folded_gain_scale``), so a clipped HLG gain codes 254.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SDR_WHITE = 203.0
PEAK_NITS = {"HLG": 1000.0, "PQ": 10000.0}

# luminance and YUV coefficients (gainmapmath.cpp:86-185)
_KR_KB = {"BT709": (0.212639, 0.072192), "BT2100": (0.2627, 0.059302),
          "P3_YUV": (0.299, 0.114)}


def _rgb2yuv(kr, kb):
    kg = 1.0 - kr - kb
    cb, cr = 2 * (1 - kb), 2 * (1 - kr)
    return [[kr, kg, kb], [-kr / cb, -kg / cb, (1 - kb) / cb],
            [(1 - kr) / cr, -kg / cr, -kb / cr]]


def _yuv2rgb(kr, kb):
    kg = 1.0 - kr - kb
    cb, cr = 2 * (1 - kb), 2 * (1 - kr)
    return [[1.0, 0.0, cr], [1.0, -kb * cb / kg, -kr * cr / kg],
            [1.0, cb, 0.0]]


YUV2RGB = {"BT2100": _yuv2rgb(*_KR_KB["BT2100"]),
           "P3": _yuv2rgb(*_KR_KB["P3_YUV"]),
           "BT709": _yuv2rgb(*_KR_KB["BT709"])}
P3_RGB2YUV = _rgb2yuv(*_KR_KB["P3_YUV"])

# RGB gamut conversions (gainmapmath.cpp:603-615): (dst, src) -> matrix
GAMUT = {
    ("P3", "BT2100"): [[1.343578, -0.282179, -0.061399],
                       [-0.065298, 1.075788, -0.01049],
                       [0.002822, -0.019598, 1.016777]],
    ("BT2100", "P3"): [[0.753833, 0.198597, 0.04757],
                       [0.045744, 0.941777, 0.012479],
                       [-0.00121, 0.017601, 0.983608]],
}


def gamut(dst: str, src: str):
    if dst == src:
        return [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]
    return GAMUT[(dst, src)]


def mat3(m, x: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[i][0] * x[0] + m[i][1] * x[1] + m[i][2] * x[2]
                        for i in range(3)])


def lut_grid(x: torch.Tensor, n: int) -> torch.Tensor:
    """The value a reference LUT of n entries returns the sample of
    (round half up of x * (n - 1), clamped)."""
    return torch.clamp(torch.floor(x * (n - 1) + 0.5), 0, n - 1) / (n - 1)


# --- transfer functions -----------------------------------------------------

def srgb_eotf(e):
    return torch.where(e <= 0.04045, e / 12.92,
                       torch.pow(torch.clamp((e + 0.055) / 1.055, min=0),
                                 2.4))


def srgb_oetf(e):
    return torch.where(e <= 0.0031308, 12.92 * e,
                       1.055 * torch.pow(torch.clamp(e, min=1e-37), 1 / 2.4)
                       - 0.055)


_HA, _HB, _HC = 0.17883277, 0.28466892, 0.55991073


def hlg_eotf_inv_oetf(e):
    return torch.where(e <= 0.5, e * e / 3.0,
                       (torch.exp((e - _HC) / _HA) + _HB) / 12.0)


def hlg_oetf(e):
    return torch.where(e <= 1 / 12,
                       torch.sqrt(torch.clamp(3 * e, min=0)),
                       _HA * torch.log(torch.clamp(12 * e - _HB, min=1e-37))
                       + _HC)


_M1, _M2 = 2610 / 16384, 2523 / 4096 * 128
_C1, _C2, _C3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32


def pq_inv_oetf(e):
    v = torch.pow(torch.clamp(e, min=0), 1 / _M2)
    return torch.pow(torch.clamp(v - _C1, min=0) / (_C2 - _C3 * v), 1 / _M1)


def pq_oetf(e):
    p = torch.pow(torch.clamp(e, min=0), _M1)
    v = torch.pow((_C1 + _C2 * p) / (1 + _C3 * p), _M2)
    return torch.where(e <= 0, torch.zeros_like(v), v)


def hdr_linear(rgb_gamma, ct: str):
    """Inverse OETF and, for HLG, the per-channel OOTF approximation."""
    if ct == "HLG":
        return torch.pow(torch.clamp(hlg_eotf_inv_oetf(rgb_gamma), min=0),
                         1.2)
    return pq_inv_oetf(rgb_gamma)


# --- encode -----------------------------------------------------------------

def unpack_p010(y16, uv16, dtype):
    """P010 (full range; the 16-bit samples in any integer carrier) ->
    (3, H, W) Y, U - 0.5, V - 0.5, chroma replicated (getP010Pixel)."""
    ten = lambda p: ((p.to(torch.int64) & 0xFFFF) >> 6).to(dtype) / 1023
    y, u, v = ten(y16), ten(uv16[:, 0::2]) - 0.5, ten(uv16[:, 1::2]) - 0.5
    rep = lambda c: c.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return torch.stack([y, rep(u), rep(v)])


def unpack_yuv420(y8, u8, v8, dtype):
    y = y8.to(dtype) / 255
    rep = lambda c: ((c.to(dtype) - 128) / 255).repeat_interleave(
        2, 0).repeat_interleave(2, 1)
    return torch.stack([y, rep(u8), rep(v8)])


def to_u8(x):
    """ScaleTo8Bit: floor(x * 255 + 0.5) clamped, as int64."""
    return torch.clamp(torch.floor(x * 255 + 0.5), 0, 255).to(torch.int64)


def tone_map_yuv420(hdr, cg: str, ct: str):
    """The API-0 SDR rendition of P010 `hdr` (3, H, W): (Y, U, V) planes,
    int64 valued 0..255, 4:2:0 (jpegr.cpp:1813-2071)."""
    rgb = torch.clamp(mat3(YUV2RGB[cg], hdr), 0, 1)
    lin = hdr_linear(rgb, ct)
    headroom = PEAK_NITS[ct] / SDR_WHITE
    x = lin * headroom
    mx = torch.amax(x, dim=0)
    mapped = (1 + mx / (headroom * headroom)) / (1 + mx) * mx
    scale = torch.where(mx > 0, mapped / torch.clamp(mx, min=1e-37), 0.0)
    sdr = torch.where(x > 0, x * scale, 0.0)
    sdr = torch.clamp(mat3(gamut("P3", cg), sdr), 0, 1)
    yuv = mat3(P3_RGB2YUV, srgb_oetf(sdr))
    h, w = yuv.shape[1:]
    quad = lambda c: (c + 0.5).reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
    return to_u8(yuv[0]), to_u8(quad(yuv[1])), to_u8(quad(yuv[2]))


def box_down(x, k: int):
    if k == 1:
        return x
    c, h, w = x.shape
    x = x[:, :h // k * k, :w // k * k]
    return x.reshape(c, h // k, k, w // k, k).mean(dim=(2, 4))


def gain_inputs(sdr_yuv, hdr_yuv, *, hdr_cg: str, ct: str, scale: int,
                use_base_cg: bool):
    """Linear SDR and HDR RGB at map resolution in the application gamut
    (jpegr.cpp:600-788); the SDR is Display-P3."""
    s = torch.clamp(mat3(YUV2RGB["P3"], box_down(sdr_yuv, scale)), 0, 1)
    s = srgb_eotf(lut_grid(s, 1024))
    hh = torch.clamp(mat3(YUV2RGB[hdr_cg], box_down(hdr_yuv, scale)), 0, 1)
    hh = hdr_linear(hh, ct)
    if hdr_cg != "P3":
        if use_base_cg:
            hh = mat3(gamut("P3", hdr_cg), hh)
        else:
            s = mat3(gamut(hdr_cg, "P3"), s)
    return torch.clamp(s, min=0), torch.clamp(hh, min=0)


def folded_gain_scale(max_boost: float) -> float:
    """The port's float32 multiplier of ln(gain) for gamma 1 and min boost
    1: (1 / ln 2) * ((1 / log2 max) * 255), each step rounded to float32."""
    f = np.float32
    ln2 = f(math.log(2.0))
    scale = f(1.0) / (f(math.log(float(f(max_boost)))) / ln2)
    return float((f(1.0) / ln2) * (scale * f(255.0)))


def gainmap_onepass(sdr_yuv, hdr_yuv, *, hdr_cg: str, ct: str, scale: int,
                    use_base_cg: bool, multichannel: bool):
    """The REALTIME map: (C, mh, mw) int64 codes (jpegr.cpp:712-828), gamma
    1, min boost 1, max boost the transfer's peak over SDR white."""
    s, h = gain_inputs(sdr_yuv, hdr_yuv, hdr_cg=hdr_cg, ct=ct, scale=scale,
                       use_base_cg=use_base_cg)
    if not multichannel:
        s, h = torch.amax(s, dim=0)[None], torch.amax(h, dim=0)[None]
    s, h = s * SDR_WHITE, h * PEAK_NITS[ct]
    max_boost = PEAK_NITS[ct] / SDR_WHITE
    g = torch.where(s > 0, h / torch.clamp(s, min=1e-37), 1.0)
    g = torch.clamp(g, 1.0, max_boost)
    x = torch.log(g) * folded_gain_scale(max_boost)
    return torch.trunc(torch.clamp(x, 0, 255)).to(torch.int64)


def gainmap_twopass(sdr_yuv, hdr_yuv, *, hdr_cg: str, ct: str, scale: int,
                    use_base_cg: bool, multichannel: bool):
    """The BEST_QUALITY map (jpegr.cpp:859-1027): ((C, mh, mw) int64 codes,
    log2 bounds lo and hi per channel as float64 numpy)."""
    s, h = gain_inputs(sdr_yuv, hdr_yuv, hdr_cg=hdr_cg, ct=ct, scale=scale,
                       use_base_cg=use_base_cg)
    if not multichannel:
        k = torch.tensor([0.2289746, 0.6917385, 0.0792869], dtype=s.dtype,
                         device=s.device)
        s = (k[:, None, None] * s).sum(0)[None]
        h = (k[:, None, None] * h).sum(0)[None]
    s, h = s * SDR_WHITE, h * PEAK_NITS[ct]
    g = torch.log2((h + 1e-7) / (s + 1e-7))
    g = torch.where(s < 2.0 / 255.0, torch.clamp(g, max=2.3), g)
    lo = torch.clamp(torch.amin(g, dim=(1, 2)), max=127).double().cpu()
    hi = torch.clamp(torch.amax(g, dim=(1, 2)), min=-128).double().cpu()
    lo = np.clip(lo.numpy(), -14.3, 15.6)
    hi = np.clip(hi.numpy(), -14.3, 15.6)
    hi = np.where(np.abs(hi - lo) < np.finfo(np.float32).eps, hi + 0.1, hi)
    lo_t = torch.as_tensor(lo, device=g.device).to(g.dtype)[:, None, None]
    hi_t = torch.as_tensor(hi, device=g.device).to(g.dtype)[:, None, None]
    m = (g - lo_t) / (hi_t - lo_t)
    codes = torch.trunc(torch.clamp(m * 255 + 0.5, 0, 255)).to(torch.int64)
    return codes, lo, hi


# --- decode -----------------------------------------------------------------

def shepard_tables(k: int) -> np.ndarray:
    """fillShepardsIDW: (4 tables, k, k, 4 neighbours), float64."""
    out = np.zeros((4, k, k, 4))
    for t, (ir, ib) in enumerate([(1, 1), (0, 1), (1, 0), (0, 0)]):
        for y in range(k):
            for x in range(k):
                px, py = x / k, y / k
                d1 = math.hypot(px, py)
                if d1 == 0:
                    out[t, y, x] = [1, 0, 0, 0]
                    continue
                w = np.array([1 / d1, 1 / math.hypot(px, py - ib),
                              1 / math.hypot(px - ir, py),
                              1 / math.hypot(px - ir, py - ib)])
                out[t, y, x] = w / w.sum()
    return out


def idw_upsample(m, k: int, h: int, w: int):
    """sampleMap's integer-factor Shepard IDW: (C, mh, mw) -> (C, h, w)."""
    if k == 1:
        return m
    dev, dt = m.device, m.dtype
    c, mh, mw = m.shape
    yl = torch.arange(h, device=dev) // k
    xl = torch.arange(w, device=dev) // k
    yu = torch.clamp(yl + 1, max=mh - 1)
    xu = torch.clamp(xl + 1, max=mw - 1)
    e = [m[:, yl][:, :, xl], m[:, yu][:, :, xl], m[:, yl][:, :, xu],
         m[:, yu][:, :, xu]]
    tabs = torch.as_tensor(shepard_tables(k), device=dev).to(dt)
    ty = torch.arange(h, device=dev) % k
    tx = torch.arange(w, device=dev) % k
    last_r = (yl >= mh - 1)[:, None]
    last_c = (xl >= mw - 1)[None, :]
    t = torch.where(last_r & last_c, 3, torch.where(
        last_c, 1, torch.where(last_r, 2, 0)))
    wts = tabs[t, ty[:, None], tx[None, :]]          # (h, w, 4)
    out = torch.zeros((c, h, w), dtype=dt, device=dev)
    for j in range(4):
        out = out + e[j] * wts[..., j][None]
    return out


def apply_gain(sdr_yuv, gain, meta, *, out_ct: str, sdr_cg: str,
               hdr_cg: str, use_base_cg: bool):
    """applyGainMap to HLG or PQ (jpegr.cpp:1448-1699), weight 1: the
    (3, H, W) int64 10-bit output codes.  meta: per-channel float lists
    (gamma, min_boost, max_boost, offset_sdr, offset_hdr)."""
    dt = sdr_yuv.dtype
    rgb = torch.clamp(mat3(YUV2RGB["P3"], sdr_yuv), 0, 1)
    lin = srgb_eotf(lut_grid(rgb, 1024))
    gm = gamut(hdr_cg, sdr_cg)
    if not use_base_cg:
        lin = mat3(gm, lin)
    out = []
    for c in range(3):
        gamma, lo, hi, osdr, ohdr = (meta[f][c] for f in (
            "gamma", "min_boost", "max_boost", "offset_sdr", "offset_hdr"))
        g = gain[c if gain.shape[0] == 3 else 0]
        if gamma != 1.0:
            g = torch.pow(torch.clamp(g, min=0), 1 / gamma)
        g = lut_grid(torch.clamp(g, 0, 1), 1024)
        lb = math.log2(lo) * (1 - g) + math.log2(hi) * g
        out.append((lin[c] + osdr) * torch.exp2(lb) - ohdr)
    hdr = torch.stack(out).to(dt)
    post = gm if use_base_cg else gamut(hdr_cg, hdr_cg)
    hdr = torch.clamp(mat3(post, hdr * (SDR_WHITE / PEAK_NITS[out_ct])),
                      0, 1)
    if out_ct == "HLG":
        e = hlg_oetf(lut_grid(torch.pow(hdr, 1 / 1.2), 65536))
    else:
        e = pq_oetf(lut_grid(hdr, 65536))
    return torch.round(torch.clamp(e, 0, 1) * 1023).to(torch.int64)
