"""Shepard's inverse-distance-weighted gain map upsampling.

Port of ``libultrahdr_tpu/ops/idw.py`` (ShepardsIDW / sampleMap /
sampleMap3Channel, gainmapmath.cpp:39-80, 871-1080) for one device.

- ``idw_upsample``, integer factors: each output pixel blends its 4
  neighbouring map texels with per-offset weight tables; the 4 neighbour
  fields are built densely (the map nearest-replicated to full resolution,
  the "upper" variants shifted by one texel with edge clamping first) and
  blended with weight fields tiled from the (k, k, 4) Shepard tables, in the
  JAX package's order of float32 sums.
- ``idw_upsample_sharded``, integer factors on one row shard of the map:
  the next shard's first map row (the halo) stands in for the row below the
  shard, and the bottom-edge tables apply only on the last shard, so the
  shards' outputs stacked equal ``idw_upsample`` of the whole map.
- ``idw_upsample_fractional``, a float factor (a map size that does not
  divide the image): per-pixel distances to the 4 enclosing texels, in the
  JAX package's float32 order of operations, with its ``hypot`` formula.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pixel


@functools.lru_cache(maxsize=32)
def shepards_weight_tables(k: int) -> np.ndarray:
    """fillShepardsIDW (gainmapmath.cpp:43-80) for all 4 tables.

    Returns (4, k, k, 4): [table(D,NR,NB,C), off_y, off_x, neighbor(e1..e4)].
    """
    out = np.zeros((4, k, k, 4), np.float32)
    for t, (inc_r, inc_b) in enumerate([(1, 1), (0, 1), (1, 0), (0, 0)]):
        for y in range(k):
            for x in range(k):
                px, py = x / k, y / k
                cx, cy = 0.0, 0.0
                nx, ny = cx + inc_r, cy + inc_b
                d1 = np.hypot(px - cx, py - cy)
                if d1 == 0.0:
                    out[t, y, x] = [1.0, 0.0, 0.0, 0.0]
                else:
                    w = np.array([1.0 / d1,
                                  1.0 / np.hypot(px - cx, py - ny),
                                  1.0 / np.hypot(px - nx, py - cy),
                                  1.0 / np.hypot(px - nx, py - ny)], np.float32)
                    out[t, y, x] = w / w.sum()
    return out


def _shift_clamp(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Shift by one map texel toward the end with edge clamping:
    index i of the result is index min(i+1, n-1) of the input."""
    n = m.shape[dim]
    return torch.cat([m.narrow(dim, 1, n - 1), m.narrow(dim, n - 1, 1)],
                     dim=dim)


def _tile_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tile a (k, k) pattern to cover (h, w)."""
    k = x.shape[0]
    return x.repeat(-(-h // k), -(-w // k))[:h, :w]


def _replicate(m: torch.Tensor, k: int, h: int, w: int) -> torch.Tensor:
    """(C, mh, mw) -> (C, h, w) nearest replication by k."""
    return torch.repeat_interleave(torch.repeat_interleave(m, k, dim=1),
                                   k, dim=2)[:, :h, :w]


def _idw_core(gainmap: torch.Tensor, down: torch.Tensor, k: int,
              out_h: int, out_w: int, rr: torch.Tensor) -> torch.Tensor:
    """IDW evaluation: `down` is the next-map-row field and `rr` the
    bottom-edge table-switch mask ((out_h, 1) bool)."""
    dev = gainmap.device
    c, mh, mw = gainmap.shape
    fields = (_replicate(gainmap, k, out_h, out_w),
              _replicate(down, k, out_h, out_w),
              _replicate(_shift_clamp(gainmap, 2), k, out_h, out_w),
              _replicate(_shift_clamp(down, 2), k, out_h, out_w))

    tables = pixel.to_device(shepards_weight_tables(k), dev)
    # edge masks: x_lower == x_upper when x//k >= mw-1 (same for y)
    cc = ((torch.arange(out_w, device=dev) // k) >= (mw - 1))[None, :]

    out = torch.zeros((c, out_h, out_w), dtype=torch.float32, device=dev)
    for j in range(4):
        w_d, w_nr, w_nb, w_c = (_tile_to(tables[t, :, :, j], out_h, out_w)
                                for t in range(4))
        w = torch.where(rr & cc, w_c,
                        torch.where(cc, w_nr, torch.where(rr, w_nb, w_d)))
        out = out + fields[j] * w[None]
    return out


def idw_upsample(gainmap: torch.Tensor, k: int, out_h: int,
                 out_w: int) -> torch.Tensor:
    """Integer-factor IDW upsample: (C, mh, mw) float -> (C, out_h, out_w),
    as sampleMap/sampleMap3Channel with ShepardsIDW tables
    (gainmapmath.cpp:923-956, 1026-1080)."""
    if k == 1 and tuple(gainmap.shape[-2:]) == (out_h, out_w):
        return gainmap
    mh = gainmap.shape[1]
    down = _shift_clamp(gainmap, 1)
    rr = ((torch.arange(out_h, device=gainmap.device) // k)
          >= (mh - 1))[:, None]
    return _idw_core(gainmap, down, k, out_h, out_w, rr)


def idw_upsample_sharded(gainmap: torch.Tensor, halo_row: torch.Tensor,
                         is_last: bool, k: int, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Row-sharded IDW upsample: gainmap is this shard's (C, mh_local, mw)
    rows, halo_row (C, 1, mw) the next shard's first map row (on the last
    shard its own last row), is_last switches the bottom-edge tables on
    where the image's edge is."""
    mh = gainmap.shape[1]
    down = torch.cat([gainmap, halo_row], dim=1)[:, 1:, :]
    rr = (((torch.arange(out_h, device=gainmap.device) // k) >= (mh - 1))
          & bool(is_last))[:, None]
    return _idw_core(gainmap, down, k, out_h, out_w, rr)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula: a = max(|x|, |y|), b = min(|x|, |y|),
    a * sqrt(1 + (b / a)**2), 0 where a == 0 (the arguments are finite)."""
    x, y = x.abs(), y.abs()
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    safe = torch.where(a == 0, torch.ones_like(a), a)
    r = b / safe
    return torch.where(a == 0, a, a * torch.sqrt(1 + r * r))


def idw_upsample_fractional(gainmap: torch.Tensor, scale: float, out_h: int,
                            out_w: int) -> torch.Tensor:
    """Float-factor IDW (sampleMap's float variant, gainmapmath.cpp:871-921,
    958-1024): (C, mh, mw) float32 -> (C, out_h, out_w), each output pixel
    blended from the 4 map texels around (x, y) / scale by inverse
    distance, a texel hit exactly returned as it is.  The float32 order of
    operations is the JAX package's; the gathers are ``index_select`` on
    rows, then on columns."""
    dev = gainmap.device
    c, mh, mw = gainmap.shape
    # a device tensor, so that CUDA divides rather than multiplying by a
    # reciprocal, as it does for a host scalar
    s = torch.full((), scale, dtype=torch.float32, device=dev)
    x_map = torch.arange(out_w, dtype=torch.float32, device=dev) / s
    y_map = torch.arange(out_h, dtype=torch.float32, device=dev) / s
    xl = torch.clamp(torch.floor(x_map).to(torch.int64), 0, mw - 1)
    xu = torch.clamp(xl + 1, 0, mw - 1)
    yl = torch.clamp(torch.floor(y_map).to(torch.int64), 0, mh - 1)
    yu = torch.clamp(yl + 1, 0, mh - 1)

    def take2(yy, xx):
        return gainmap.index_select(1, yy).index_select(2, xx)

    e1, e2, e3, e4 = take2(yl, xl), take2(yu, xl), take2(yl, xu), \
        take2(yu, xu)
    dx_l = (x_map - xl.to(torch.float32))[None, :]
    dx_u = (x_map - xu.to(torch.float32))[None, :]
    dy_l = (y_map - yl.to(torch.float32))[:, None]
    dy_u = (y_map - yu.to(torch.float32))[:, None]
    d1, d2 = _hypot(dx_l, dy_l), _hypot(dx_l, dy_u)
    d3, d4 = _hypot(dx_u, dy_l), _hypot(dx_u, dy_u)

    eps = 1e-12
    w1, w2, w3, w4 = (1.0 / (d + eps) for d in (d1, d2, d3, d4))
    tot = w1 + w2 + w3 + w4
    blended = (e1 * w1 + e2 * w2 + e3 * w3 + e4 * w4) / tot
    # exact hits (the reference returns the sample when its distance is 0)
    blended = torch.where(d4[None] == 0.0, e4, blended)
    blended = torch.where(d3[None] == 0.0, e3, blended)
    blended = torch.where(d2[None] == 0.0, e2, blended)
    return torch.where(d1[None] == 0.0, e1, blended)
