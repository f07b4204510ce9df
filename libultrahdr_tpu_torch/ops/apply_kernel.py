"""Fused apply-gainmap: SDR YUV + full-resolution gain -> packed HDR output.

Port of the Pallas TPU kernel ``libultrahdr_tpu/ops/pallas_apply.py``
``apply_gainmap_pallas`` (both branches: HLG/PQ to RGBA1010102 and LINEAR to
RGBAF16), in four pieces:

- ``meta_to_rows``: the metadata arrays as the kernel's (5, 3) rows, as the
  JAX package builds them;
- ``apply_gainmap_plain``: the plain PyTorch version, a transcription of
  ``_apply_tile_channels`` op for op, with the per-channel gain in
  ``apply_gain``.  The CPU tests hold it against the TPU
  kernel in interpret mode, and ``chip_smoke.py`` holds the CUDA kernel
  against it on the card;
- ``APPLY_KERNEL``: the wrapper of the hand-written CUDA kernel
  ``csrc/apply_kernel.cu`` (see its header for the design and what bounds
  it on the H100).  It builds the kernel with nvcc for sm_90a at first use
  into ``_build/``, builds the kernel's request-independent tables once per
  device (``APPLY_KERNEL.tables``, set-up), launches it on PyTorch's current
  stream, raises on a refused launch, and counts its launches in
  ``APPLY_KERNEL.launches`` (those of the LINEAR branch, the TPU kernel's
  other ``pallas_call``, also in ``APPLY_KERNEL.linear_launches``);
- ``apply_gainmap``: the dispatcher.  A CPU tensor goes to the plain
  version, a CUDA tensor to the kernel; anything else raises.  Nothing
  falls back: a failed build or launch propagates.

All three take sdr_yuv (3, H, W) float32, gain (C, H, W) float32 in [0, 1]
with C = 1 (one plane for all three channels) or 3, meta_rows (5, 3) float32
numpy rows [gamma, min_boost, max_boost, offset_sdr, offset_hdr] and the
weight; they return (H, W) int32 holding RGBA1010102 u32 patterns for HLG
and PQ, or (H, W, 4) int16 holding RGBA half-float u16 patterns for LINEAR
(``ops/pixel.py`` states the carrier types).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported
from ..types import ColorGamut, ColorTransfer
from . import colors, pixel
from .lut_parity import (GAIN_FACTOR_N, HLG_OETF_N, PQ_OETF_N,
                         SRGB_INV_OETF_N, lut_quantize)

_OUTPUTS = (ColorTransfer.HLG, ColorTransfer.PQ, ColorTransfer.LINEAR)


def meta_to_rows(metadata_arrays) -> np.ndarray:
    """metadata dict (ops/apply.metadata_to_arrays) -> (5,3) kernel rows."""
    return np.stack([metadata_arrays["gamma"],
                     metadata_arrays["min_content_boost"],
                     metadata_arrays["max_content_boost"],
                     metadata_arrays["offset_sdr"],
                     metadata_arrays["offset_hdr"]]).astype(np.float32)


def _mat3(m, chans):
    """Constant 3x3 matrix times a list of three (H, W) channels."""
    m = np.asarray(m, np.float32)
    return [float(m[r, 0]) * chans[0] + float(m[r, 1]) * chans[1]
            + float(m[r, 2]) * chans[2] for r in range(3)]


def apply_gain(rgb_sdr, gain: torch.Tensor, metadata_arrays,
               weight: float):
    """applyGainLUT (gainmapmath.cpp:849-855 + GainLUT, gainmapmath.h:452-495),
    the JAX package's ``ops/apply.apply_gain``: three (H, W) linear SDR
    channels and the gain (C, H, W) in [0, 1] (C = 1 serves all three
    channels) -> three linear HDR channels referenced to SDR white."""
    dev = gain.device
    meta = torch.from_numpy(np.asarray(metadata_arrays, np.float32)).to(dev)
    w_scalar = torch.tensor(np.float32(weight), device=dev)
    rgb_hdr = []
    for c in range(3):
        gamma, min_b, max_b, off_s, off_h = meta[:, c]
        g = gain[c if gain.shape[0] == 3 else 0]
        g = torch.where(gamma != 1.0,
                        torch.pow(torch.clamp(g, min=0.0), 1.0 / gamma), g)
        # GainLUT::getGainFactor snaps the post-gamma gain to the 1024-grid
        g = lut_quantize(torch.clamp(g, 0.0, 1.0), GAIN_FACTOR_N)
        log_boost = torch.log2(min_b) * (1.0 - g) + torch.log2(max_b) * g
        rgb_hdr.append((rgb_sdr[c] + off_s)
                       * torch.exp2(log_boost * w_scalar) - off_h)
    return rgb_hdr


def apply_gainmap_plain(sdr_yuv: torch.Tensor, gain: torch.Tensor,
                        meta_rows, weight: float, *, out_ct: ColorTransfer,
                        sdr_cg: ColorGamut, hdr_cg: ColorGamut,
                        use_base_cg: bool) -> torch.Tensor:
    """Plain PyTorch version of the apply kernel (any device)."""
    out_ct = ColorTransfer(out_ct)
    if out_ct not in _OUTPUTS:
        raise unsupported(f"apply: no output transfer {out_ct.name}")

    rgb_gamma = _mat3(colors.P3_YUV2RGB, [sdr_yuv[0], sdr_yuv[1], sdr_yuv[2]])
    rgb_sdr = [colors.srgb_inv_oetf(
        lut_quantize(torch.clamp(c, 0.0, 1.0), SRGB_INV_OETF_N))
        for c in rgb_gamma]
    gamut_m = colors.gamut_conversion_matrix(hdr_cg, sdr_cg)
    if not use_base_cg:
        rgb_sdr = _mat3(gamut_m, rgb_sdr)
    rgb_hdr = apply_gain(rgb_sdr, gain, meta_rows, weight)

    post_gamut = gamut_m if use_base_cg else np.eye(3, dtype=np.float32)
    if out_ct == ColorTransfer.LINEAR:
        rgb_hdr = _mat3(post_gamut, rgb_hdr)
        return pixel.pack_rgbaf16(
            colors.clamp_pixel_float_linear(torch.stack(rgb_hdr)))
    if out_ct == ColorTransfer.HLG:
        scale = colors.SDR_WHITE_NITS / colors.HLG_MAX_NITS
        rgb_hdr = _mat3(post_gamut, [c * scale for c in rgb_hdr])
        rgb_hdr = [torch.clamp(c, 0.0, 1.0) for c in rgb_hdr]
        rgb_hdr = [torch.pow(torch.clamp(c, min=0.0), 1.0 / 1.2)
                   for c in rgb_hdr]
        out = [colors.hlg_oetf(lut_quantize(c, HLG_OETF_N)) for c in rgb_hdr]
    else:  # PQ
        scale = colors.SDR_WHITE_NITS / colors.PQ_MAX_NITS
        rgb_hdr = _mat3(post_gamut, [c * scale for c in rgb_hdr])
        rgb_hdr = [torch.clamp(c, 0.0, 1.0) for c in rgb_hdr]
        out = [colors.pq_oetf(lut_quantize(c, PQ_OETF_N)) for c in rgb_hdr]
    return pixel.pack_rgba1010102(torch.stack(out))


class _ApplyParams(ctypes.Structure):
    """The kernel's ApplyParams (csrc/apply_kernel.cu)."""

    _fields_ = [("yuv2rgb", ctypes.c_float * 9),
                ("gamut", ctypes.c_float * 9),
                ("meta", ctypes.c_float * 15),
                ("weight", ctypes.c_float),
                ("use_base_cg", ctypes.c_int)]


_PTR = ctypes.c_void_p
APPLY_LIB = CudaLibrary("apply_kernel", {
    "uhdr_apply_tables": [_PTR] * 4,
    "uhdr_apply_gainmap": [
        _PTR, _PTR, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_ApplyParams), ctypes.c_int, _PTR, _PTR, _PTR,
        _PTR]})


class _ApplyKernel:
    """Wrapper of csrc/apply_kernel.cu: per-device tables, launch, launch
    count."""

    def __init__(self):
        self.launches = 0
        self.linear_launches = 0
        self._tables: dict[torch.device, dict[str, torch.Tensor]] = {}

    def tables(self, dev: torch.device) -> dict[str, torch.Tensor]:
        """The kernel's request-independent tables on `dev`, built by
        uhdr_apply_tables at first use: "srgb" (1024,) float32, the sRGB
        inverse OETF on the 1024 grid; "hlg" and "pq" (65536,) int16
        holding the 10-bit codes of each OETF on the 65536 grid."""
        if dev not in self._tables:
            lib = APPLY_LIB.build()
            t = {"srgb": torch.empty(SRGB_INV_OETF_N, dtype=torch.float32,
                                     device=dev),
                 "hlg": torch.empty(HLG_OETF_N, dtype=torch.int16,
                                    device=dev),
                 "pq": torch.empty(PQ_OETF_N, dtype=torch.int16, device=dev)}
            check_launch(lib, lib.uhdr_apply_tables(
                t["srgb"].data_ptr(), t["hlg"].data_ptr(), t["pq"].data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream),
                "uhdr_apply_tables")
            self._tables[dev] = t
        return self._tables[dev]

    def __call__(self, sdr_yuv: torch.Tensor, gain: torch.Tensor, meta_rows,
                 weight: float, *, out_ct: ColorTransfer, sdr_cg: ColorGamut,
                 hdr_cg: ColorGamut, use_base_cg: bool) -> torch.Tensor:
        out_ct = ColorTransfer(out_ct)
        if out_ct not in _OUTPUTS:
            raise unsupported(f"apply: no output transfer {out_ct.name}")
        dev = sdr_yuv.device
        if dev.type != "cuda":
            raise ValueError(f"apply kernel needs CUDA tensors, got {dev}")
        if sdr_yuv.dim() != 3 or sdr_yuv.shape[0] != 3:
            raise ValueError(f"apply kernel: sdr_yuv must be (3, H, W), got "
                             f"{tuple(sdr_yuv.shape)}")
        h, w = sdr_yuv.shape[1], sdr_yuv.shape[2]
        chans = gain.shape[0] if gain.dim() == 3 else -1
        for name, t, shape in (("sdr_yuv", sdr_yuv, (3, h, w)),
                               ("gain", gain, (chans, h, w))):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != shape or chans not in (1, 3)
                    or not t.is_contiguous()):
                raise ValueError(
                    f"apply kernel: {name} must be a contiguous float32 "
                    f"{shape} tensor on {dev} (gain with 1 or 3 channels), "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        rows = np.asarray(meta_rows, np.float32)
        if rows.shape != (5, 3):
            raise ValueError(f"apply kernel: meta_rows must be (5, 3), got "
                             f"{rows.shape}")
        params = _ApplyParams()
        params.yuv2rgb[:] = np.asarray(colors.P3_YUV2RGB, np.float32).ravel()
        params.gamut[:] = np.asarray(
            colors.gamut_conversion_matrix(hdr_cg, sdr_cg), np.float32).ravel()
        params.meta[:] = rows.ravel()
        params.weight = float(np.float32(weight))
        params.use_base_cg = int(bool(use_base_cg))
        if out_ct == ColorTransfer.LINEAR:
            out = torch.empty((h, w, 4), dtype=torch.int16, device=dev)
        else:
            out = torch.empty((h, w), dtype=torch.int32, device=dev)
        lib = APPLY_LIB.build()
        tables = self.tables(dev)
        code = tables["pq" if out_ct == ColorTransfer.PQ else "hlg"]
        check_launch(lib, lib.uhdr_apply_gainmap(
            sdr_yuv.data_ptr(), gain.data_ptr(), h * w if chans == 3 else 0,
            h, w, ctypes.byref(params), int(out_ct),
            tables["srgb"].data_ptr(), code.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "uhdr_apply_gainmap")
        self.launches += 1
        self.linear_launches += int(out_ct == ColorTransfer.LINEAR)
        return out


APPLY_KERNEL = _ApplyKernel()


def apply_gainmap(sdr_yuv: torch.Tensor, gain: torch.Tensor, meta_rows,
                  weight: float, *, out_ct: ColorTransfer, sdr_cg: ColorGamut,
                  hdr_cg: ColorGamut, use_base_cg: bool) -> torch.Tensor:
    """Dispatcher: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors.  No fallback between the two."""
    kw = dict(out_ct=out_ct, sdr_cg=sdr_cg, hdr_cg=hdr_cg,
              use_base_cg=use_base_cg)
    if sdr_yuv.device.type == "cpu":
        return apply_gainmap_plain(sdr_yuv, gain, meta_rows, weight, **kw)
    if sdr_yuv.device.type == "cuda":
        return APPLY_KERNEL(sdr_yuv, gain, meta_rows, weight, **kw)
    raise unsupported(f"no apply implementation for device {sdr_yuv.device}")
