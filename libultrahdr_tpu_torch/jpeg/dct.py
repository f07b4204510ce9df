"""Batched 8x8 forward DCT and quantisation in PyTorch.

Port of ``libultrahdr_tpu/jpeg/dct.py`` ``forward_plane``: each plane is
reshaped to expose the two 8-point axes and transformed with two small
float32 matrix products, then quantised (round half to even, like libjpeg
ISLOW's descale) and zigzag-reordered.  The products run in full float32:
the package turns TF32 off (``libultrahdr_tpu_torch/__init__.py``), as the
JAX package runs this at HIGHEST precision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .tables import ZIGZAG_ORDER


@functools.lru_cache(maxsize=1)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D.

    The separable orthonormal 2-D transform D x D^T equals the T.81 Annex A
    FDCT exactly (the 1/4 C(u)C(v) normalization is the product of the two
    1-D scale factors), so quant tables apply directly."""
    k = np.arange(8)
    d = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    d[0, :] = np.sqrt(1.0 / 8.0)
    return d.astype(np.float32)


def forward_plane(plane_u8: torch.Tensor, qtable_natural) -> torch.Tensor:
    """uint8 (H, W) plane, H and W multiples of 8 -> zigzagged quantized
    coefficients (H/8, W/8, 64) int16.  Level shift -128, FDCT, quantize,
    zigzag reorder."""
    dev = plane_u8.device
    x = plane_u8.to(torch.float32) - 128.0
    h, w = x.shape
    blocks = x.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
    d = torch.from_numpy(dct_matrix()).to(dev)
    coeffs = torch.matmul(torch.matmul(d, blocks), d.T)
    q = torch.as_tensor(np.asarray(qtable_natural, np.float32).reshape(8, 8),
                        device=dev)
    quant = torch.round(coeffs / q).to(torch.int16)
    flat = quant.reshape(h // 8, w // 8, 64)
    return flat[..., torch.as_tensor(ZIGZAG_ORDER, dtype=torch.long,
                                     device=dev)]
