"""Scan layout and stream-order glue for the device Huffman pack.

Port of the parts of ``libultrahdr_tpu/jpeg/device_entropy.py`` and
``pack_kernel._stream_inputs`` that the encode slice runs:

- ``scan_layout``: the static (host numpy) description of one interleaved
  scan with one restart interval per MCU row;
- ``_interleave_stream``: the T.81 A.2.3 MCU interleave as pure reshapes and
  permutes;
- ``stream_inputs``: coefficient planes -> (stream (n_blocks, 64) int16 in
  MCU stream order, DC diffs (n_blocks,) int32 whose predictor resets at every
  MCU row, is_luma (n_blocks,) int32) -- the inputs of the pack kernel
  (``pack_kernel.py``).

Restart rows are byte-aligned and reset the DC predictor (T.81 E.2.4), which
removes every dependency between rows, and inside a row each block's symbols
depend only on its own coefficients and DC diff.  So every block packs
independently; the host joiner (``native.join_blocks``) byte-aligns the rows
and inserts the RST markers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class ScanLayout(NamedTuple):
    """Static description of one interleaved scan."""

    sampling: tuple            # ((h,v), ...) per component
    mcus_w: int
    mcus_h: int
    bpr: int                   # blocks per restart row (= per MCU row)
    is_luma: np.ndarray        # (bpr,) bool: stream position of component 0


@functools.lru_cache(maxsize=64)
def scan_layout(sampling: tuple, mcus_w: int, mcus_h: int) -> ScanLayout:
    """Stream-order layout of an interleaved scan (T.81 A.2.3): per MCU,
    each component's hs*vs blocks in turn."""
    mcu = [c == 0 for c, (hs, vs) in enumerate(sampling)
           for _ in range(hs * vs)]
    is_luma = np.asarray(mcu * mcus_w, bool)
    return ScanLayout(tuple(sampling), mcus_w, mcus_h, is_luma.size, is_luma)


def _interleave_stream(per_comp, layout: ScanLayout) -> torch.Tensor:
    """Per-component (mcus_h*vs, mcus_w*hs, X) block tensors -> interleaved
    stream order (mcus_h, bpr, X)."""
    mh, mw = layout.mcus_h, layout.mcus_w
    parts = []
    for arr, (hs, vs) in zip(per_comp, layout.sampling):
        x = arr.reshape((mh, vs, mw, hs) + tuple(arr.shape[2:]))
        x = x.transpose(1, 2)                     # (mh, mw, vs, hs, X)
        parts.append(x.reshape((mh, mw, vs * hs) + tuple(arr.shape[2:])))
    stream = torch.cat(parts, dim=2)              # (mh, mw, bpr_mcu, X)
    return stream.reshape((mh, layout.bpr) + tuple(stream.shape[3:]))


def stream_inputs(coeff_planes, layout: ScanLayout):
    """Coefficient planes (MCU padded, (bh, bw, 64) int16 zigzag) -> the
    pack inputs (stream (n, 64) int16, dc_diff (n,) int32, is_luma (n,)
    int32) in MCU stream order, DC predictor reset per MCU row (restart
    rows, T.81 F.1.2)."""
    mh, mw = layout.mcus_h, layout.mcus_w
    dev = coeff_planes[0].device
    stream = _interleave_stream(
        [p.to(torch.int16) for p in coeff_planes], layout)
    comp_diffs = []
    for p, (hs, vs) in zip(coeff_planes, layout.sampling):
        dcs = p[..., 0].to(torch.int32).reshape(mh, vs, mw, hs)
        dcs = dcs.transpose(1, 2).reshape(mh, mw * vs * hs)
        prev = torch.cat([torch.zeros_like(dcs[:, :1]), dcs[:, :-1]], dim=1)
        comp_diffs.append((dcs - prev).reshape(mh, mw, vs * hs))
    dc_diff = torch.cat(comp_diffs, dim=2).reshape(-1)
    is_luma = torch.from_numpy(
        np.tile(layout.is_luma.astype(np.int32), mh)).to(dev)
    return stream.reshape(-1, 64).contiguous(), dc_diff.contiguous(), is_luma


def total_words(block_len_bits: np.ndarray) -> int:
    """Host-side: compacted word count implied by the block bit lengths."""
    return int(np.sum((np.asarray(block_len_bits).astype(np.int64) + 31)
                      >> 5))
