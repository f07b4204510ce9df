"""Scan layout, stream-order glue and Huffman symbols for the device packs.

Port of the parts of ``libultrahdr_tpu/jpeg/device_entropy.py`` and
``pack_kernel._stream_inputs`` that the port's packs run:

- ``scan_layout``: the static (host numpy) description of one interleaved
  scan with one restart interval per MCU row;
- ``_interleave_stream``: the T.81 A.2.3 MCU interleave as pure reshapes and
  permutes;
- ``stream_inputs``: coefficient planes -> (stream (n_blocks, 64) int16 in
  MCU stream order, DC diffs (n_blocks,) int32 whose predictor resets at every
  MCU row, is_luma (n_blocks,) int32) -- the inputs of the pack kernel
  (``pack_kernel.py``);
- ``block_slots`` / ``slot_symbols``: every block's 65 Huffman slots
  (payload, length), the symbol math that the plain versions of all three
  packers share (the JAX ``_slot_symbols``);
- ``PackOverflowError`` and ``_default_budget``: the static word budget of the
  tile pack (``pack_kernel.pack_tiles``).

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

from ..ops.pixel import to_device
from .tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA


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
    is_luma = to_device(np.tile(layout.is_luma.astype(np.int32), mh), dev)
    return stream.reshape(-1, 64).contiguous(), dc_diff.contiguous(), is_luma


def total_words(block_len_bits: np.ndarray) -> int:
    """Host-side: compacted word count implied by the block bit lengths
    (the JAX ``total_words_v2``)."""
    return int(np.sum((np.asarray(block_len_bits).astype(np.int64) + 31)
                      >> 5))


_BLOCK_CAP_WORDS = 54          # ceil(worst-case block bits / 32) + slack


class PackOverflowError(RuntimeError):
    """A kernel tile's words exceeded the tile pack's static word budget
    (adversarial content at high quality): the tile's tail was dropped."""


def _default_budget(n_blocks: int) -> int:
    """Words per block of the tile pack's budget: the full worst-case cap
    for small scans, a lean 16 for big ones."""
    return _BLOCK_CAP_WORDS if n_blocks <= 32768 else 16


# ---------------------------------------------------------------------------
# Huffman symbols

@functools.lru_cache(maxsize=1)
def packed_luts() -> np.ndarray:
    """(544,) u32 Huffman table, code << 5 | length, laid out
    [DC luma 16][DC chroma 16][AC luma 256][AC chroma 256] (the DC tables'
    entries 12..15 are unused categories, zero like the TPU kernel's)."""
    def packed(t, n):
        return (np.asarray(t.code_of[:n], np.uint32) << 5) \
            | np.asarray(t.size_of[:n], np.uint32)
    return np.concatenate([packed(DC_LUMA, 16), packed(DC_CHROMA, 16),
                           packed(AC_LUMA, 256), packed(AC_CHROMA, 256)])


def _bit_size(v: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category of int64 values, capped at 15 like the TPU
    kernel's 15-compare _bit_size_vec: frexp's exponent is bit_length(|v|)
    exactly for |v| < 2^24."""
    e = torch.frexp(v.abs().to(torch.float32)).exponent.to(torch.int64)
    return e.clamp(max=15)


def _value_bits(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """One's-complement style extra bits (T.81 F.1.2.1), int64."""
    one = torch.ones_like(size)
    x = torch.where(v < 0, v + (one << size) - 1, v)
    return x & ((one << size) - 1)


def block_slots(stream: torch.Tensor, dc_diff: torch.Tensor,
                is_luma: torch.Tensor):
    """The stream inputs -> every block's 65 slots [DC, 63 AC positions (a
    ZRL or a code, never both), EOB] of (payload, length), both (n, 65)
    int64; an inactive slot is (0, 0) and a payload is below 2^length."""
    dev = stream.device
    lut = to_device(packed_luts().astype(np.int64), dev)
    code, length = lut >> 5, lut & 31
    chroma = (is_luma == 0).to(torch.int64)              # (n,) table row
    dc_base = chroma * 16
    ac_base = 32 + chroma * 256

    # ---- DC slot --------------------------------------------------------
    d = dc_diff.to(torch.int64)
    ds = _bit_size(d)
    dc_pay = (code[dc_base + ds] << ds) | _value_bits(d, ds)
    dc_len = length[dc_base + ds] + ds

    # ---- AC slots -------------------------------------------------------
    ac = stream[:, 1:].to(torch.int64)                   # (n, 63)
    nz = ac != 0
    k = torch.arange(1, 64, dtype=torch.int64, device=dev)
    incl = torch.cummax(torch.where(nz, k, 0), dim=1).values
    prev_nz = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    last_nz = incl[:, -1:]
    zrl_on = ~nz & ((k - prev_nz) % 16 == 0) & (k < last_nz)
    run = (k - prev_nz - 1) % 16
    asz = _bit_size(ac)
    sym = ac_base[:, None] + torch.where(nz, (run << 4) | asz, 0)
    zrl = ac_base[:, None] + 0xF0
    ac_pay = torch.where(nz, (code[sym] << asz) | _value_bits(ac, asz),
                         torch.where(zrl_on, code[zrl], 0))
    ac_len = torch.where(nz, length[sym] + asz,
                         torch.where(zrl_on, length[zrl], 0))

    eob_on = last_nz[:, 0] < 63
    eob_pay = torch.where(eob_on, code[ac_base], 0)
    eob_len = torch.where(eob_on, length[ac_base], 0)

    pays = torch.cat([dc_pay[:, None], ac_pay, eob_pay[:, None]], dim=1)
    lens = torch.cat([dc_len[:, None], ac_len, eob_len[:, None]], dim=1)
    return pays, lens


def slot_symbols(coeff_planes, layout: ScanLayout):
    """Coefficient planes -> per-block 65-slot (payload, length) int64
    arrays in stream order, shaped (n_rows, bpr, 65): the JAX
    ``_slot_symbols``."""
    pays, lens = block_slots(*stream_inputs(coeff_planes, layout))
    shape = (layout.mcus_h, layout.bpr, 65)
    return pays.reshape(shape), lens.reshape(shape)
