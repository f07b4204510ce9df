"""The benchmark's input images, made from the seed.

``photo_p010`` is the port's ``testing.photo_p010`` copied: tiles of a
committed 320x240 photograph (``data/photo_yu12_320x240.npz``), each tile
mirrored and given a gain, plus a soft highlight, as 10-bit P010.  A cell's
pool is that scene at the configuration's size, rolled by offsets drawn
from the seed, so every seed sends the same amount of picture detail in
another arrangement.
"""

from __future__ import annotations

import pathlib

import numpy as np

PHOTO_NPZ = pathlib.Path(__file__).resolve().parent / "data" / \
    "photo_yu12_320x240.npz"


def photo_p010(w: int, h: int, seed: int = 11):
    """(Y, UV) uint16 P010 planes of the photographic scene."""
    z = np.load(PHOTO_NPZ)
    y8, u8, v8 = z["y"], z["u"], z["v"]
    rs = np.random.RandomState(seed)
    fh, fw = y8.shape
    ty, tx = -(-h // fh), -(-w // fw)
    gains = 0.7 + 0.6 * rs.rand(ty, tx).astype(np.float32)

    def tile(p, th, tw):
        rows = []
        for iy in range(ty):
            cells = []
            for ix in range(tx):
                t = p.astype(np.float32) * gains[iy, ix]
                if ix % 2:
                    t = t[:, ::-1]
                if iy % 2:
                    t = t[::-1, :]
                cells.append(t)
            rows.append(np.concatenate(cells, axis=1))
        return np.concatenate(rows, axis=0)[:th, :tw]

    lum = tile(y8, h, w) / 255.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hl = 0.25 * np.exp(-(((yy / h - 0.3) ** 2 + (xx / w - 0.7) ** 2)
                         / 0.08))
    y10 = np.clip((0.1 + 0.65 * lum + hl) * 1023, 0, 1023)
    y10 = y10.astype(np.uint16) << 6
    cu = tile(u8, h // 2, w // 2)
    cv = tile(v8, h // 2, w // 2)
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = np.clip(cu * 4.0, 0, 1023).astype(np.uint16) << 6
    uv[:, 1::2] = np.clip(cv * 4.0, 0, 1023).astype(np.uint16) << 6
    return np.ascontiguousarray(y10), np.ascontiguousarray(uv)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose of one run: any whole-number seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         *stream]))


def pool(w: int, h: int, n: int, seed: int):
    """n distinct P010 images: the scene rolled by even offsets drawn from
    the seed (even, so that each 2x2 chroma quad stays whole)."""
    y, uv = photo_p010(w, h)
    r = rng(seed, 1)
    out = []
    for _ in range(n):
        dy = 2 * int(r.integers(0, h // 2))
        dx = 2 * int(r.integers(0, w // 2))
        out.append((np.ascontiguousarray(np.roll(y, (dy, dx), (0, 1))),
                    np.ascontiguousarray(np.roll(uv, (dy // 2, dx),
                                                 (0, 1)))))
    return out
