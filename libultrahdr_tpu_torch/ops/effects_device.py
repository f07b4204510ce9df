"""Editor effects on the device-resident packed decode output.

Port of ``libultrahdr_tpu/ops/effects_device.py``: the reference edits the
still-resident texture with GLES shaders (apply_{mirror,rotate,crop,
resize}_gles, lib/src/gpu/editorhelper_gl.cpp:1-355) and reads it back once;
here ``JpegR.decode_to_device`` leaves the packed output on the device and
these functions edit it there, in plain PyTorch (a flip, a rotation, a
slice and an integer-stride gather move whole pixels and compute nothing,
so no kernel is written for them).

The semantics are editor.py's, which are editorhelper.cpp's:
  - rotate is clockwise (rotate_buffer_clockwise, editorhelper.cpp:21-48);
  - resize is nearest with INTEGER-division strides, including the upscale
    quirk where a stride of 0 repeats row and column 0 (resize_buffer,
    editorhelper.cpp:77-86);
  - packed pixels move as whole units: an (H, W) int32 RGBA1010102 tensor
    or an (H, W, 4) int16 RGBAF16 tensor (editorhelper.cpp:162-165).

Every result owns its storage, as the JAX package's arrays do: a rotation is
not left a transposed view, nor a crop a slice that keeps the whole frame
alive.
"""

from __future__ import annotations

import torch

from ..errors import invalid_param
from ..types import MirrorDirection


def _owned(t: torch.Tensor) -> torch.Tensor:
    """t itself when it is contiguous and its storage holds it alone, else
    a contiguous copy."""
    if t.is_contiguous() and t.storage_offset() == 0 and \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def mirror_packed(arr: torch.Tensor, direction: MirrorDirection):
    axis = 0 if MirrorDirection(direction) == MirrorDirection.VERTICAL else 1
    return _owned(torch.flip(arr, dims=(axis,)))


def rotate_packed(arr: torch.Tensor, degrees: int):
    if degrees not in (90, 180, 270):
        raise invalid_param(f"unsupported rotation {degrees}")
    k = {90: -1, 180: 2, 270: 1}[degrees]
    return _owned(torch.rot90(arr, k, dims=(0, 1)))


def crop_packed(arr: torch.Tensor, left: int, top: int, w: int, h: int):
    return _owned(arr[top:top + h, left:left + w])


def resize_packed(arr: torch.Tensor, dst_w: int, dst_h: int):
    """Nearest with integer strides (resize_buffer, editorhelper.cpp:77-86)."""
    sh, sw = arr.shape[0], arr.shape[1]
    ri = torch.arange(dst_h, device=arr.device) * (sh // dst_h)
    ci = torch.arange(dst_w, device=arr.device) * (sw // dst_w)
    return _owned(arr.index_select(0, ri).index_select(1, ci))


def apply_effects_packed(arr: torch.Tensor, effects, base_w=None,
                         base_h=None):
    """Apply an effect queue (``api.MirrorEffect`` / ``RotateEffect`` /
    ``CropEffect`` / ``ResizeEffect``) to a packed output on its device.

    Returns (tensor, w, h).  The size the coordinates start from is
    (`base_w`, `base_h`) when given, as in the JAX package, else the
    array's.  Crop and resize are validated as apply_effects validates them
    for the display image (ultrahdr_api.cpp:275-415); the device-resident
    decode returns no gain map, so none is edited."""
    from ..api import CropEffect, MirrorEffect, ResizeEffect, RotateEffect
    h = arr.shape[0] if base_h is None else base_h
    w = arr.shape[1] if base_w is None else base_w
    for eff in effects:
        if isinstance(eff, MirrorEffect):
            arr = mirror_packed(arr, eff.direction)
        elif isinstance(eff, RotateEffect):
            arr = rotate_packed(arr, eff.degrees)
            if eff.degrees in (90, 270):
                w, h = h, w
        elif isinstance(eff, CropEffect):
            left, right = max(0, eff.left), min(w, eff.right)
            top, bottom = max(0, eff.top), min(h, eff.bottom)
            if right <= left or bottom <= top:
                raise invalid_param("invalid crop dimensions")
            arr = crop_packed(arr, left, top, right - left, bottom - top)
            w, h = right - left, bottom - top
        elif isinstance(eff, ResizeEffect):
            if eff.width <= 0 or eff.height <= 0:
                raise invalid_param(
                    f"unsupported resize dimensions {eff.width}x{eff.height}")
            arr = resize_packed(arr, eff.width, eff.height)
            w, h = eff.width, eff.height
        else:
            raise invalid_param(f"unsupported device effect {eff}")
    return arr, w, h
