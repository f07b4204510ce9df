"""Editor effects: mirror, rotate, crop, resize (host numpy).

The port's copy of ``libultrahdr_tpu/editor.py``, kept as it is: its
float64 bicubic and its truncations are the reference's bytes.  The decode's
aspect-ratio resize of a gain map uses ``resize_channels``; the effect queue
of ``api.UhdrEncoder`` (on the raw intents) and ``api.UhdrDecoder`` (on the
output and its gain map) uses the ``apply_*`` effects.

Re-design of editorhelper (reference lib/src/editorhelper.cpp):
numpy whole-plane transforms replace the templated per-pixel loops and the
NEON/GLES variants; per-plane application honors chroma subsampling
(editorhelper.cpp:239-283: P010 interleaved UV at half dims, 420 chroma at
w/2 x h/2, 444 per-plane).

"Bicubic" resize replicates the reference's 4-neighbor Bernstein blend
(bicubic_interpolate + resize_image, editorhelper.cpp:88-146) exactly,
including its use of the x-fraction only.
"""

from __future__ import annotations

import numpy as np

from .errors import invalid_param, unsupported
from .types import ImgFmt, MirrorDirection, RawImage


def _plane_views(img: RawImage):
    """Per-plane arrays with P010 UV exposed as a (h/2, w/2) uint32 view
    (editorhelper.cpp:239-243)."""
    fmt = ImgFmt(img.fmt)
    if fmt == ImgFmt.P010:
        y = img.planes[0]
        uv = img.planes[1]
        uv32 = uv.reshape(uv.shape[0], uv.shape[1] // 2, 2).copy().view(np.uint32)[..., 0]
        return [y, uv32]
    return img.planes


def _rebuild(img: RawImage, planes, w, h) -> RawImage:
    fmt = ImgFmt(img.fmt)
    if fmt == ImgFmt.P010:
        uv32 = planes[1]
        uv = uv32[..., None].view(np.uint16).reshape(uv32.shape[0], uv32.shape[1] * 2)
        planes = [planes[0], np.ascontiguousarray(uv)]
    return RawImage(fmt, img.cg, img.ct, img.range, w, h,
                    [np.ascontiguousarray(p) for p in planes])


def apply_mirror(img: RawImage, direction: MirrorDirection) -> RawImage:
    axis = 0 if direction == MirrorDirection.VERTICAL else 1
    planes = [np.flip(p, axis=axis) for p in _plane_views(img)]
    return _rebuild(img, planes, img.w, img.h)


def apply_rotate(img: RawImage, degrees: int) -> RawImage:
    """Clockwise rotation by 90/180/270 (rotate_buffer_clockwise,
    editorhelper.cpp:21-48)."""
    if degrees not in (90, 180, 270):
        raise invalid_param(f"unsupported rotation {degrees}")
    def rot(p):
        if degrees == 90:
            return np.rot90(p, k=-1)   # clockwise
        if degrees == 180:
            return np.rot90(p, k=2)
        return np.rot90(p, k=1)
    planes = [rot(p) for p in _plane_views(img)]
    w, h = (img.h, img.w) if degrees in (90, 270) else (img.w, img.h)
    return _rebuild(img, planes, w, h)


def apply_crop(img: RawImage, left: int, top: int, w: int, h: int) -> RawImage:
    """Crop; chroma planes use coordinates scaled by their subsampling."""
    fmt = ImgFmt(img.fmt)
    out = []
    for i, p in enumerate(_plane_views(img)):
        if i == 0:
            out.append(p[top:top + h, left:left + w])
        else:
            sx = img.w // p.shape[1] if p.shape[1] else 1
            sy = img.h // p.shape[0] if p.shape[0] else 1
            out.append(p[top // sy: (top + h) // sy,
                         left // sx: (left + w) // sx])
    return _rebuild(img, out, w, h)


def _bicubic_plane(p: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """resize_image inner loop (editorhelper.cpp:100-146) vectorized.

    Values are normalized floats; caller quantizes per the put-pixel rule."""
    src_h, src_w = p.shape
    scale_x = src_w / dst_w
    scale_y = src_h / dst_h
    ox = np.arange(dst_w) * scale_x
    oy = np.arange(dst_h) * scale_y
    x0 = np.clip(np.floor(ox).astype(np.int64), 0, src_w - 1)
    y0 = np.clip(np.floor(oy).astype(np.int64), 0, src_h - 1)
    x1 = np.clip(x0 + 1, 0, src_w - 1)
    y1 = np.clip(y0 + 1, 0, src_h - 1)
    fx = (ox - x0)[None, :]
    p0 = p[np.ix_(y0, x0)].astype(np.float64)
    p1 = p[np.ix_(y0, x1)].astype(np.float64)
    p2 = p[np.ix_(y1, x0)].astype(np.float64)
    p3 = p[np.ix_(y1, x1)].astype(np.float64)
    w0 = (1 - fx) ** 3
    w1 = 3 * fx * (1 - fx) ** 2
    w2 = 3 * fx * fx * (1 - fx)
    w3 = fx ** 3
    return w0 * p0 + w1 * p1 + w2 * p2 + w3 * p3


def resize_channels(gain_u8: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Resize a (C, h, w) uint8 gain map with the reference's bicubic
    (used by applyGainMap on aspect mismatch, jpegr.cpp:1525-1545).
    Values pass through get-pixel normalization (x/255) and the put-pixel
    quantization (*255 +0.5 truncate)."""
    out = np.stack([
        _bicubic_plane(c.astype(np.float64) / 255.0, dst_w, dst_h)
        for c in gain_u8])
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _resize_legacy(p: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Effect-path resize template (resize_buffer, editorhelper.cpp:77-86):
    nearest sampling with INTEGER-division strides — replicated exactly,
    including the upscale quirk where src_dim // dst_dim == 0 repeats
    row/column 0."""
    sh, sw = p.shape
    ri = np.arange(dst_h) * (sh // dst_h)
    ci = np.arange(dst_w) * (sw // dst_w)
    return p[np.ix_(ri, ci)]


def apply_resize(img: RawImage, dst_w: int, dst_h: int) -> RawImage:
    """Effect-path resize (apply_resize, editorhelper.cpp:417-483): each
    plane resampled at its subsampled dims; P010 UV pairs and packed
    RGBA/F16 pixels move as single u32/u64 units like the reference's
    template instantiations (editorhelper.cpp:162-165)."""
    fmt = ImgFmt(img.fmt)
    if fmt == ImgFmt.RGBAF16:
        packed = img.planes[0]
        if packed.ndim == 3:  # (h, w, 4) u16 component layout -> u64 view
            p64 = np.ascontiguousarray(packed).view(np.uint64)[..., 0]
        else:
            p64 = packed
        out = _resize_legacy(p64, dst_w, dst_h)
        comp = np.ascontiguousarray(out)[..., None].view(np.uint16) \
            .reshape(dst_h, dst_w, 4)
        return RawImage(fmt, img.cg, img.ct, img.range, dst_w, dst_h,
                        [np.ascontiguousarray(comp)])
    planes = []
    for i, p in enumerate(_plane_views(img)):
        sx = max(1, img.w // p.shape[1])
        sy = max(1, img.h // p.shape[0])
        planes.append(_resize_legacy(p, dst_w // sx, dst_h // sy))
    return _rebuild(img, planes, dst_w, dst_h)
