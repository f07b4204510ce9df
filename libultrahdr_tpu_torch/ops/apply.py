"""Decode: apply the gain map to the SDR base -> HDR output.

Port of ``libultrahdr_tpu/ops/apply.py`` (JpegR::applyGainMap,
jpegr.cpp:1448-1699, with applyGain/GainLUT, gainmapmath.cpp:791-855):

    SDR YUV (Rec601) -> RGB -> sRGB EOTF -> [gamut] -> x gainFactor
        -> output transfer (linear F16 | HLG 1010102 | PQ 1010102)

The per-pixel math runs in ``apply_kernel`` (the CUDA kernel on the card,
its plain version on the CPU).  At an integer scale k > 1 the IDW upsample
first produces the full-resolution float32 gain in plain PyTorch, as the
JAX package ran it in plain XLA.  A fractional map scale reaches
``apply_gainmap_core`` already upsampled (``JpegR.apply_gainmap``:
``idw.idw_upsample_fractional``), as a float gain at scale 1 that passes
through unchanged.  The per-channel gain formula ``apply_gain`` lives in
``apply_kernel`` with the rest of the per-pixel math and is re-exported
here under its JAX module.  A row shard of the image (``parallel``) passes
the next shard's first map row as ``gain_halo_row``; its IDW is then
``idw.idw_upsample_sharded``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import ColorGamut, ColorTransfer
from . import apply_kernel, idw
from .apply_kernel import apply_gain  # noqa: F401
from .lut_parity import (GAIN_FACTOR_N, HLG_OETF_N,  # noqa: F401
                         PQ_OETF_N, SRGB_INV_OETF_N)  # (JAX's names)


def gainmap_weight(max_display_boost: float, cap_min: float,
                   cap_max: float) -> float:
    """display_boost / weight computation (jpegr.cpp:1556-1568)."""
    display_boost = min(max_display_boost, cap_max)
    if display_boost != cap_max:
        w = (np.log2(display_boost) - np.log2(cap_min)) / \
            (np.log2(cap_max) - np.log2(cap_min))
        return float(np.clip(w, 0.0, 1.0))
    return 1.0


def _gain_to_float(g: torch.Tensor) -> torch.Tensor:
    """Gain samples to normalized f32: u8 maps /255; float dtypes pass
    through (the reference samples a float map without re-quantizing,
    gainmapmath.cpp:871-921)."""
    if g.dtype.is_floating_point:
        return g.to(torch.float32)
    return g.to(torch.float32) / 255.0


def apply_gainmap_core(sdr_yuv: torch.Tensor, gain_u8: torch.Tensor,
                       metadata_arrays, *, scale_k: int, weight,
                       out_ct: ColorTransfer, sdr_cg: ColorGamut,
                       hdr_cg: ColorGamut, use_base_cg: bool,
                       gain_halo_row=None, edge_is_last=None) -> torch.Tensor:
    """Fused decode: SDR YUV (3,H,W) + gain map (C,mh,mw) u8, or a float
    gain already at full resolution with scale_k 1 -> packed output, (H,W)
    int32 RGBA1010102 patterns (HLG/PQ) or (H,W,4) int16 RGBAF16 patterns
    (LINEAR) (jpegr.cpp:1636-1680).

    gain_halo_row / edge_is_last: the row-sharded IDW's inputs (the next
    shard's first map row, (C, 1, mw), and whether this is the bottom
    shard, see ``idw.idw_upsample_sharded``); None on one device."""
    h, w = sdr_yuv.shape[1], sdr_yuv.shape[2]
    gain_f = _gain_to_float(gain_u8)
    if gain_halo_row is not None and scale_k > 1:
        gain = idw.idw_upsample_sharded(gain_f, _gain_to_float(gain_halo_row),
                                        edge_is_last, scale_k, h, w)
    else:
        gain = idw.idw_upsample(gain_f, scale_k, h, w)
    return apply_kernel.apply_gainmap(sdr_yuv, gain.contiguous(),
                 apply_kernel.meta_to_rows(metadata_arrays), weight,
                 out_ct=ColorTransfer(out_ct), sdr_cg=sdr_cg, hdr_cg=hdr_cg,
                 use_base_cg=use_base_cg)


def metadata_to_arrays(metadata) -> dict:
    """GainMapMetadata -> dict of (3,) float32 arrays."""
    return {
        "gamma": np.asarray(metadata.gamma, np.float32),
        "min_content_boost": np.asarray(metadata.min_content_boost, np.float32),
        "max_content_boost": np.asarray(metadata.max_content_boost, np.float32),
        "offset_sdr": np.asarray(metadata.offset_sdr, np.float32),
        "offset_hdr": np.asarray(metadata.offset_hdr, np.float32),
    }
