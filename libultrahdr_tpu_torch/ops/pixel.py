"""Pixel format unpack/pack: raw integer planes <-> planar float32 (3, H, W).

Port of ``libultrahdr_tpu/ops/pixel.py``: the unpackers, the ``unpack``
dispatcher over a ``RawImage`` and the packers.  Packed images keep the JAX package's layouts in
torch's signed carriers: RGBA1010102 and RGBA8888 are (H, W) int32 tensors
holding the u32 bit patterns (an opaque alpha sets bit 31, so every value is
negative as int32), RGBAF16 an (H, W, 4) int16 tensor holding the u16
half-float patterns, 16-bit sample planes (P010, YUV444_10) int16 tensors
holding the u16 samples; the host views them as np.uint32 / np.uint16.
Subsampled chroma is unpacked to full resolution by replication, numerically
identical to the reference's getYuv420Pixel-style nearest indexing
(gainmapmath.cpp:354-448), so the tone map and the gain map see one uniform
(3, H, W) float32 layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import unsupported
from ..types import ColorRange, ImgFmt, RawImage
from .colors import sanitize_pixel

# signed torch carrier of a 16- or 32-bit numpy sample width
_CARRIER = {2: np.int16, 4: np.int32}


def host_tensor(a) -> torch.Tensor:
    """A contiguous CPU tensor sharing a numpy array's memory (a copy when
    the array is read-only, which torch cannot share)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def pinned(x) -> torch.Tensor:
    """A copy of a host array or CPU tensor in pinned memory (PyTorch's
    caching host allocator), made by one numpy copy on the calling thread:
    ``Tensor.pin_memory()`` copies on PyTorch's CPU thread pool, which
    stalls when the other host threads of a pipeline hold the cores
    (PERF.md, PR 7)."""
    t = x if isinstance(x, torch.Tensor) else host_tensor(x)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    np.copyto(out.numpy(), t.numpy())
    return out


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on `device`.  To the card it travels
    through pinned memory as a copy queued on the current stream, so the
    host does not wait for the card (a pageable copy would); the caching
    host allocator keeps the pinned block until that copy has run.  An
    already pinned tensor is not copied again on the host."""
    t = x if isinstance(x, torch.Tensor) else host_tensor(x)
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    if not t.is_pinned():
        t = pinned(t)
    return t.to(device, non_blocking=True)


def plane_tensor(p, device: torch.device) -> torch.Tensor:
    """A host plane (numpy) or a tensor on `device`, one transfer at most
    (to_device): 16- and 32-bit samples travel as int16 / int32 views of
    their patterns, 8-bit ones as uint8."""
    if isinstance(p, torch.Tensor):
        return to_device(p, device)
    a = np.ascontiguousarray(p)
    if a.dtype.itemsize in _CARRIER:
        a = a.view(_CARRIER[a.dtype.itemsize])
    return to_device(a, device)


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


def _u16(p: torch.Tensor) -> torch.Tensor:
    """16-bit sample pattern of any integer carrier (int16 views included),
    as float32."""
    return (p.to(torch.int32) & 0xFFFF).to(torch.float32)


def unpack_yuv444_10(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     rng: ColorRange) -> torch.Tensor:
    """30bpp YCbCr444 (three planes of 10-bit samples in the low bits) ->
    (3,H,W) float (gainmapmath.cpp:398-423)."""
    yf, uf, vf = _u16(y), _u16(u), _u16(v)
    if ColorRange(rng) == ColorRange.FULL:
        return torch.stack([yf / 1023.0, uf / 1023.0 - 0.5,
                            vf / 1023.0 - 0.5])
    return torch.stack([(yf - 64.0) * (1.0 / 876.0),
                        (uf - 64.0) * (1.0 / 896.0) - 0.5,
                        (vf - 64.0) * (1.0 / 896.0) - 0.5])


def unpack_rgba8888(packed: torch.Tensor) -> torch.Tensor:
    """(H,W) int32 u32 patterns -> (3,H,W) float in [0,1]
    (gainmapmath.cpp:462-472).  R bits 7:0, G 15:8, B 23:16."""
    return torch.stack([((packed >> s) & 0xFF).to(torch.float32)
                        for s in (0, 8, 16)]) / 255.0


def unpack_rgb888(arr: torch.Tensor) -> torch.Tensor:
    """uint8 (H,W,3) -> (3,H,W) float in [0,1] (gainmapmath.cpp:451-460)."""
    return arr.to(torch.float32).permute(2, 0, 1) / 255.0


def unpack_rgba1010102(packed: torch.Tensor) -> torch.Tensor:
    """(H,W) int32 u32 patterns -> (3,H,W) float in [0,1]
    (gainmapmath.cpp:474-484).  R bits 9:0, G 19:10, B 29:20."""
    return torch.stack([((packed >> s) & 0x3FF).to(torch.float32)
                        for s in (0, 10, 20)]) / 1023.0


def unpack_rgbaf16(comp: torch.Tensor) -> torch.Tensor:
    """(H,W,4) int16 [r,g,b,a] half-float patterns -> (3,H,W) float32,
    sanitized (getRgbaF16Pixel, gainmapmath.cpp:486-495): the bitcast is
    the reference's halfToFloat for every finite, inf and nan input."""
    rgb = comp.view(torch.float16)[..., :3].permute(2, 0, 1)
    return sanitize_pixel(rgb.to(torch.float32))


def unpack(img: RawImage, device: torch.device) -> torch.Tensor:
    """RawImage -> (3, H, W) float32 YUV or RGB 'gamma' values on `device`,
    the dispatch analog of getPixelFn (gainmapmath.cpp:1221-1246).  The
    planes may be host arrays or tensors already on the device."""
    f = ImgFmt(img.fmt)
    h, w = img.h, img.w

    def planes(n):
        return [plane_tensor(p, device) for p in img.planes[:n]]
    sub = {ImgFmt.YUV444: (1, 1), ImgFmt.YUV422: (2, 1),
           ImgFmt.YUV420: (2, 2)}
    if f in sub:
        return unpack_yuv8(*planes(3), *sub[f], h, w)
    if f == ImgFmt.YUV400:
        y = planes(1)[0].to(torch.float32) * (1.0 / 255.0)
        z = torch.zeros_like(y)
        return torch.stack([y, z, z])
    if f == ImgFmt.P010:
        return unpack_p010(*planes(2), ColorRange(img.range), h, w)
    if f == ImgFmt.YUV444_10:
        return unpack_yuv444_10(*planes(3), ColorRange(img.range))
    one = {ImgFmt.RGBA8888: unpack_rgba8888, ImgFmt.RGB888: unpack_rgb888,
           ImgFmt.RGBA1010102: unpack_rgba1010102,
           ImgFmt.RGBAF16: unpack_rgbaf16}
    if f in one:
        return one[f](planes(1)[0])
    raise unsupported(f"no unpack implementation for format {f}")


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


def pack_yuv444(yuv: torch.Tensor):
    """(3,H,W) gamma YUV (chroma centered at 0) -> 3 uint8 planes: toneMap's
    444 store, chroma += 0.5, then putYuv444Pixel's *255 +0.5 truncate-clamp
    (jpegr.cpp:2047-2052, gainmapmath.cpp:578-600)."""
    y = torch.clamp(yuv[0] * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    u = torch.clamp((yuv[1] + 0.5) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    v = torch.clamp((yuv[2] + 0.5) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return y, u, v


# 255 << 24, the opaque alpha of RGBA8888, as an int32 pattern
_ALPHA_8888 = -(1 << 24)


def pack_rgba8888(rgb: torch.Tensor) -> torch.Tensor:
    """(3,H,W) float [0,1] -> (H,W) int32 u32 patterns, alpha 255
    (putRgba8888Pixel, gainmapmath.cpp:540-554: *255 +0.5 truncate)."""
    q = torch.clamp(rgb * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
    return q[0] | (q[1] << 8) | (q[2] << 16) | _ALPHA_8888


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
