"""Pixel format unpack/pack: raw integer planes <-> planar float32 (3, H, W).

Port of the parts of ``libultrahdr_tpu/ops/pixel.py`` that the API-0 P010
encode and the fused decode run.  Packed outputs keep the JAX package's
layouts in torch's signed carriers: RGBA1010102 is an (H, W) int32 tensor
holding the u32 bit patterns (the 0x3 << 30 alpha sets bit 31, so every
value is negative as int32), RGBAF16 an (H, W, 4) int16 tensor holding the
u16 half-float patterns; the host views them as np.uint32 / np.uint16.
Subsampled chroma is unpacked to full resolution by replication, numerically
identical to the reference's getYuv420Pixel-style nearest indexing
(gainmapmath.cpp:354-448), so the tone map and the gain map see one uniform
(3, H, W) float32 layout.
"""

from __future__ import annotations

import torch

from ..types import ColorRange


def _replicate_chroma(c: torch.Tensor, hf: int, vf: int) -> torch.Tensor:
    """Nearest-neighbor chroma upsample, matching getYuv4abPixel indexing."""
    if vf > 1:
        c = torch.repeat_interleave(c, vf, dim=0)
    if hf > 1:
        c = torch.repeat_interleave(c, hf, dim=1)
    return c


def unpack_yuv8(y, u, v, hf: int, vf: int, h: int, w: int) -> torch.Tensor:
    """8-bit planar YCbCr -> (3,H,W) float, 128-biased chroma
    (gainmapmath.cpp:354-388)."""
    yf = y.to(torch.float32) * (1.0 / 255.0)
    uf = (u.to(torch.float32) - 128.0) * (1.0 / 255.0)
    vf_ = (v.to(torch.float32) - 128.0) * (1.0 / 255.0)
    uf = _replicate_chroma(uf, hf, vf)[:h, :w]
    vf_ = _replicate_chroma(vf_, hf, vf)[:h, :w]
    return torch.stack([yf[:h, :w], uf, vf_])


def unpack_p010(y: torch.Tensor, uv: torch.Tensor, rng: ColorRange, h: int,
                w: int) -> torch.Tensor:
    """P010 semiplanar -> (3,H,W) float (gainmapmath.cpp:425-448).

    y: (h, w) and uv: (h/2, w) interleaved U,V, any integer dtype holding
    the 16-bit sample pattern (data in the 10 MSB; int16 views included)."""
    def ten(p):
        return ((p.to(torch.int32) & 0xFFFF) >> 6).to(torch.float32)
    y10, u10, v10 = ten(y), ten(uv[:, 0::2]), ten(uv[:, 1::2])
    if ColorRange(rng) == ColorRange.FULL:
        yf = y10 / 1023.0
        uf = u10 / 1023.0 - 0.5
        vf = v10 / 1023.0 - 0.5
    else:
        yf = (y10 - 64.0) * (1.0 / 876.0)
        uf = (u10 - 64.0) * (1.0 / 896.0) - 0.5
        vf = (v10 - 64.0) * (1.0 / 896.0) - 0.5
    uf = _replicate_chroma(uf, 2, 2)[:h, :w]
    vf = _replicate_chroma(vf, 2, 2)[:h, :w]
    return torch.stack([yf[:h, :w], uf, vf])


def _scale_u8(x: torch.Tensor) -> torch.Tensor:
    """ScaleTo8Bit (jpegr.cpp:1848-1852): round-half-up then clamp to
    [0,255]."""
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0.0, 255.0) \
        .to(torch.uint8)


def pack_yuv420(yuv: torch.Tensor):
    """(3,H,W) gamma YUV (chroma centered at 0) -> (Y,U,V) uint8 planes with
    2x2 chroma averaging after the +0.5 bias, all via ScaleTo8Bit, as the
    toneMap 420 store path does (jpegr.cpp:2044-2071)."""
    y = _scale_u8(yuv[0])
    h2, w2 = (yuv.shape[1] // 2) * 2, (yuv.shape[2] // 2) * 2
    u = yuv[1][:h2, :w2] + 0.5
    v = yuv[2][:h2, :w2] + 0.5
    u = u.reshape(h2 // 2, 2, w2 // 2, 2).mean(dim=(1, 3))
    v = v.reshape(h2 // 2, 2, w2 // 2, 2).mean(dim=(1, 3))
    return y, _scale_u8(u), _scale_u8(v)


# 0x3 << 30, the opaque 2-bit alpha of RGBA1010102, as an int32 pattern
_ALPHA_1010102 = -(1 << 30)
# half(1.0), the alpha of RGBAF16
_ALPHA_F16 = 0x3C00


def pack_rgba1010102(rgb: torch.Tensor) -> torch.Tensor:
    """colorToRgba1010102 (gainmapmath.cpp:1279-1283): clip, round half to
    even, pack; (3,H,W) float -> (H,W) int32 u32 patterns."""
    q = torch.round(torch.clamp(rgb, 0.0, 1.0) * 1023.0).to(torch.int32)
    return q[0] | (q[1] << 10) | (q[2] << 20) | _ALPHA_1010102


def pack_rgbaf16(rgb: torch.Tensor) -> torch.Tensor:
    """colorToRgbaF16 (gainmapmath.cpp:1285-1289): (3,H,W) f32 -> (H,W,4)
    int16 half-float patterns, alpha = half(1.0)."""
    h16 = rgb.to(torch.float16).view(torch.int16)
    a = torch.full(rgb.shape[1:], _ALPHA_F16, dtype=torch.int16,
                   device=rgb.device)
    return torch.stack([h16[0], h16[1], h16[2], a], dim=-1)


def box_downsample(x: torch.Tensor, k: int) -> torch.Tensor:
    """Box-average over k x k blocks: (..., H, W) -> (..., H//k, W//k),
    like samplePixels (gainmapmath.cpp:497-507)."""
    if k == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    mh, mw = h // k, w // k
    x = x[..., : mh * k, : mw * k]
    x = x.reshape(*x.shape[:-2], mh, k, mw, k)
    return x.mean(dim=(-3, -1))
