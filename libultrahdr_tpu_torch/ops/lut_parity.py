"""Reference-LUT numeric parity without lookup tables.

Port of ``libultrahdr_tpu/ops/lut_parity.py``.  The reference routes hot-path
transfer functions through lookup tables (USE_*_LUT, gainmapmath.h:27-32)
indexed by round-half-up of x*(N-1) (gainmapmath.cpp:127-134 etc.).  A LUT
lookup of a monotone function f equals f(q(x)) where q snaps x to the LUT
grid, so one multiply/floor/clip replaces the gather and keeps the
reference's f32 results.
"""

from __future__ import annotations

import torch

# the LUT grids are always applied (the JAX package's switch, always on)
PARITY = True

# LUT sizes (gainmapmath.h:274-342, 449-450)
SRGB_INV_OETF_N = 1 << 10
HLG_OETF_N = 1 << 16
HLG_INV_OETF_N = 1 << 12
PQ_OETF_N = 1 << 16
PQ_INV_OETF_N = 1 << 12
GAIN_FACTOR_N = 1 << 10


def lut_quantize(x: torch.Tensor, n: int) -> torch.Tensor:
    """Snap x in [0,1] to the reference's N-entry LUT grid (round-half-up,
    clamped)."""
    idx = torch.clamp(torch.floor(x * (n - 1) + 0.5), 0.0, float(n - 1))
    return idx * (1.0 / (n - 1))
