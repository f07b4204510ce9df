"""Huffman symbol generation, bit packing and compaction of JPEG blocks.

Port of the three Pallas TPU kernels of ``libultrahdr_tpu/jpeg/pack_kernel.py``,
each as a trio of a plain PyTorch version, the wrapper of a hand-written CUDA
kernel and a dispatcher:

=================  ==================  =================  =====================
TPU kernel         plain version       kernel wrapper     dispatcher
=================  ==================  =================  =====================
_pack_tiles_v3     pack_scan_plain     PACK_KERNEL        pack_scan
pack_blocks_pallas pack_blocks_plain   PACK_BLOCKS_KERNEL pack_blocks
pack_tiles_pallas  pack_tiles_plain    PACK_TILES_KERNEL  pack_tiles
=================  ==================  =================  =====================

- The plain versions do their bit math in int64 (torch's uint32 op coverage
  is thin); the tests hold them against the TPU kernels in interpret mode,
  and ``chip_smoke.py`` holds each CUDA kernel against its plain version on
  the card.
- The wrappers build their kernel with nvcc for sm_90a at first use into
  ``_build/`` (``csrc/pack_kernel.cu``; ``csrc/block_pack_kernel.cu`` for
  both of the others, see each file's header for the design and what bounds
  it on the H100), launch it on PyTorch's current stream, raise on a refused
  launch, and count their launches in ``.launches``.  Each splits into
  ``buffers()`` (the outputs) and ``launch()`` (the kernel alone, counted),
  so that a kernel can be timed without its wrapper's host work.
- The dispatchers send a CPU tensor to the plain version and a CUDA tensor
  to the kernel; anything else raises.  Nothing falls back: a failed build
  or launch propagates.

``pack_scan`` (the "v3" engine, the one the encode runs) takes the stream
inputs of ``device_entropy.stream_inputs`` (stream (n, 64) int16 zigzag
coefficients in MCU stream order, dc_diff (n,) int32, is_luma (n,) int32)
and returns (words (total,) int32 holding u32 bit patterns, blen (n,)
int32): block b's MSB-first bitstream sits word-aligned at the exclusive
prefix sum of ceil(blen/32), and blen has no restart-row pad.  The kernel
codes every block once, in one launch, into room for CAP_WORDS words a
block; its wrapper then waits for the card (an ``encode.wait`` span,
``utils.profiling``), reads the total word count (8 bytes, the one
synchronisation) and returns that prefix of the room as ``words``.  It is a
view: the whole room (n x CAP_WORDS words, about 145 MB for a default 4K
request against about 10 MB of live words) stays allocated for as long as
the caller holds ``words``, so a caller that keeps the result copies it.
``pack_scan_queued``, the fused encode's entry, launches the kernel alone
and returns the whole room and blen without waiting: the join on the card
(``join_kernel``) reads the words where they lie.

``pack_blocks`` ("v1") and ``pack_tiles`` ("v2") take the slots of
``slots_for_kernel``: (n, 72) int32 payloads (u32 patterns, each below
2^length) and lengths, the 65 symbol slots of every block, its row's
byte-align pad as the 66th slot (on a row's last block) and zero padding.
Their blen includes that pad.  ``pack_blocks`` writes one 54-word buffer per
block in the blocks-in-lanes layout (54, n), which ``compact_blocks_t``
compacts; ``pack_tiles`` compacts each 2048-block tile within a static word
budget, and ``stitch_tiles`` chains the tiles' live prefixes.  No request of
the library runs these two: their path is the JAX package's own entry
points, driven end to end by ``testing.pack_scans_v1`` / ``pack_scans_v2``,
and their joined scans are byte-identical to the v3 engine's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported
from ..utils import stage
from . import device_entropy as de
from .device_entropy import packed_luts


def _u32_bits_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _place_bits(pays: torch.Tensor, lens: torch.Tensor,
                first_word: torch.Tensor, size: int) -> torch.Tensor:
    """OR slot bits MSB-first into a zeroed (size,) int64 buffer of u32
    words: row b's slots (int64 payload < 2^length, length <= 26) follow each
    other from bit 0 of word first_word[b].  The in-row exclusive scan of the
    lengths gives each slot's absolute bit position, and each slot lands in
    at most two words through two index_adds (the bit ranges are disjoint,
    so add == or).  An empty slot after the last bit may sit at word size
    when the stream ends on a word boundary, so the buffer has two words of
    room past the end."""
    bitpos = first_word[:, None] * 32 + torch.cumsum(lens, 1) - lens
    w = (bitpos >> 5).reshape(-1)
    s = (bitpos & 31).reshape(-1)
    msb = (pays << (32 - lens)).reshape(-1)              # MSB-aligned u32
    hi = msb >> s
    lo = (msb & ((torch.ones_like(s) << s) - 1)) << (32 - s)
    words = torch.zeros(size + 2, dtype=torch.int64, device=pays.device)
    words.index_add_(0, w, hi)
    words.index_add_(0, w + 1, lo)
    return words[:size]


def pack_scan_plain(stream: torch.Tensor, dc_diff: torch.Tensor,
                    is_luma: torch.Tensor):
    """Plain PyTorch version of the pack kernel (any device): every block's
    65 slots (device_entropy.block_slots) placed at the block's word offset,
    the exclusive prefix sum of ceil(blen/32)."""
    pays, lens = de.block_slots(stream, dc_diff, is_luma)
    blen = lens.sum(dim=1)
    wlen = (blen + 31) >> 5
    dest = torch.cumsum(wlen, 0) - wlen
    words = _place_bits(pays, lens, dest, int(wlen.sum()))
    return _u32_bits_as_i32(words), blen.to(torch.int32)


_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
PACK_LIB = CudaLibrary("pack_kernel", {
    "uhdr_pack_scan": [_PTR] * 4 + [_I64, _INT, _I64] + [_PTR] * 4})

# Words of the output reserved per block: the worst case a block can need.
# At most 64 of its symbols carry bits (the DC and one per AC position: a
# ZRL sits on a zero position, and the EOB comes only when position 63 is
# zero and so holds no code), each at most a 16-bit code (T.81's limit) and
# 15 value bits (_bit_size caps there): 64 x 31 = 1984 bits.
CAP_WORDS = 64 * (16 + 15) // 32
_SCAN_TILE = 128            # blocks per tile of uhdr_pack_scan


class _PackKernel:
    """Wrapper of csrc/pack_kernel.cu: per-device tables, launch, launch
    count."""

    def __init__(self):
        self.launches = 0
        self._luts: dict[torch.device, torch.Tensor] = {}

    def _lut(self, dev: torch.device) -> torch.Tensor:
        if dev not in self._luts:
            self._luts[dev] = torch.from_numpy(
                packed_luts().view(np.int32)).to(dev)
        return self._luts[dev]

    def setup(self, dev: torch.device):
        """Build the kernel and upload its table to `dev` on the current
        stream (both happen at first use otherwise)."""
        PACK_LIB.build()
        self._lut(dev)

    def __call__(self, stream: torch.Tensor, dc_diff: torch.Tensor,
                 is_luma: torch.Tensor):
        self.check(stream, dc_diff, is_luma)
        out = self.buffers(stream.shape[0], stream.device)
        self.launch(stream, dc_diff, is_luma, *out)
        scratch, blen, words = out
        # the wait that the count's read would make, as a span of its own
        with stage("encode.wait"):
            torch.cuda.current_stream(stream.device).synchronize()
        return words[:int(scratch[1])], blen

    @staticmethod
    def check(stream: torch.Tensor, dc_diff: torch.Tensor,
              is_luma: torch.Tensor):
        """Raise unless the inputs are what the kernel reads."""
        dev = stream.device
        n = stream.shape[0]
        if dev.type != "cuda":
            raise ValueError(f"pack kernel needs CUDA tensors, got {dev}")
        for name, t, dtype, shape in (
                ("stream", stream, torch.int16, (n, 64)),
                ("dc_diff", dc_diff, torch.int32, (n,)),
                ("is_luma", is_luma, torch.int32, (n,))):
            if (t.device != dev or t.dtype != dtype
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"pack kernel: {name} must be a contiguous {dtype} "
                    f"{shape} tensor on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if any(t.data_ptr() % 16 for t in (stream, dc_diff, is_luma)):
            raise ValueError("pack kernel: stream, dc_diff and is_luma must "
                             "be 16-byte aligned")

    @staticmethod
    def buffers(n: int, dev: torch.device):
        """(scratch, blen, words) for n blocks: the zeroed int64 scratch
        ([0] the tile counter, [1] the total word count, [2:] a status word
        per tile), (n,) int32 lengths and room for CAP_WORDS words a
        block."""
        return (torch.zeros(2 + -(-n // _SCAN_TILE), dtype=torch.int64,
                            device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n * CAP_WORDS, dtype=torch.int32, device=dev))

    def launch(self, stream, dc_diff, is_luma, scratch, blen, words):
        """The kernel alone on checked inputs and zeroed buffers()."""
        lib = PACK_LIB.build()
        dev = stream.device
        check_launch(lib, lib.uhdr_pack_scan(
            stream.data_ptr(), dc_diff.data_ptr(), is_luma.data_ptr(),
            self._lut(dev).data_ptr(), stream.shape[0], CAP_WORDS,
            scratch.numel(), scratch.data_ptr(), blen.data_ptr(),
            words.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "uhdr_pack_scan")
        self.launches += 1


PACK_KERNEL = _PackKernel()


def pack_scan(stream: torch.Tensor, dc_diff: torch.Tensor,
              is_luma: torch.Tensor):
    """Dispatcher: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors.  No fallback between the two."""
    if stream.device.type == "cpu":
        return pack_scan_plain(stream, dc_diff, is_luma)
    if stream.device.type == "cuda":
        return PACK_KERNEL(stream, dc_diff, is_luma)
    raise unsupported(f"no pack implementation for device {stream.device}")


def pack_scan_queued(stream: torch.Tensor, dc_diff: torch.Tensor,
                     is_luma: torch.Tensor):
    """Dispatcher for a caller that reads the words on the device (the
    fused encode's join, ``join_kernel``): the plain version for CPU
    tensors; for CUDA tensors the kernel's launch alone, which returns
    (the whole room of CAP_WORDS words a block, blen) without waiting for
    the card or reading the word count."""
    if stream.device.type != "cuda":
        return pack_scan(stream, dc_diff, is_luma)
    PACK_KERNEL.check(stream, dc_diff, is_luma)
    scratch, blen, words = PACK_KERNEL.buffers(stream.shape[0],
                                               stream.device)
    PACK_KERNEL.launch(stream, dc_diff, is_luma, scratch, blen, words)
    return words, blen


# ---------------------------------------------------------------------------
# v1 / v2: slot inputs -> block buffers (54, n), and per-tile compaction

_SLOTS = 72                 # 65 symbol slots + the row pad + zero padding
_CAP = de._BLOCK_CAP_WORDS  # 54 words per block buffer
_TILE = 2048                # blocks per compacted tile


def slots_for_kernel(coeff_planes, layout: de.ScanLayout):
    """Coefficient planes -> the (n_blocks, 72) int32 slot payloads and
    lengths of one scan: its blocks' 65 symbol slots, the row byte-align pad
    (1-bits, T.81 F.1.2.3) as a 66th slot on each MCU row's last block, and
    zero slots up to 72 (the JAX ``_slots_for_kernel``)."""
    pays, lens = de.slot_symbols(coeff_planes, layout)   # (rows, bpr, 65)
    n_rows, bpr = layout.mcus_h, layout.bpr
    pad_len = (-lens.sum(dim=(1, 2))) % 8                # (rows,)
    last = torch.zeros((n_rows, bpr), dtype=torch.bool, device=lens.device)
    last[:, -1] = True
    pad_len = torch.where(last, pad_len[:, None], 0)
    pad_pay = (torch.ones_like(pad_len) << pad_len) - 1
    zero = torch.zeros((n_rows, bpr, _SLOTS - 66), dtype=torch.int64,
                       device=lens.device)
    pays = torch.cat([pays, pad_pay[..., None], zero], dim=-1)
    lens = torch.cat([lens, pad_len[..., None], zero], dim=-1)
    n = n_rows * bpr
    return (pays.reshape(n, _SLOTS).to(torch.int32),
            lens.reshape(n, _SLOTS).to(torch.int32))


def pack_blocks_plain(pays: torch.Tensor, lens: torch.Tensor):
    """Plain version of the block pack (any device): (n, 72) slots ->
    (bb_t (54, n) int32, blen (n,) int32).  Block b's slots go MSB-first
    into column b from its first word; words past blen are zero.  Every
    block must fit its 54 words, as every block of slots_for_kernel does
    (at most 1,701 of 1,728 bits)."""
    pays64 = pays.to(torch.int64) & 0xFFFFFFFF
    lens64 = lens.to(torch.int64)
    n = pays64.shape[0]
    first = torch.arange(n, dtype=torch.int64, device=pays.device) * _CAP
    words = _place_bits(pays64, lens64, first, n * _CAP).view(n, _CAP)
    return (_u32_bits_as_i32(words.T.contiguous()),
            lens64.sum(dim=1).to(torch.int32))


def pack_tiles_plain(pays: torch.Tensor, lens: torch.Tensor, budget: int):
    """Plain version of the tile pack (any device): (n, 72) slots ->
    (tiles (n_tiles, 2048 * budget) int32, blen (n,) int32).  The block
    buffers of pack_blocks_plain, each tile of 2048 blocks compacted to its
    front: block b's live words at its tile's exclusive prefix sum of
    ceil(blen/32).  Words at or past the tile's budget are dropped, as the
    TPU kernel drops them (check_tile_budgets detects it); the rest of a
    tile is undefined, as on the TPU (read the live prefixes with
    tile_live_words and stitch_tiles)."""
    bb_t, blen = pack_blocks_plain(pays, lens)
    n = blen.shape[0]
    dev = blen.device
    tile_words = _TILE * budget
    n_tiles = -(-n // _TILE)
    wlen = (blen.to(torch.int64) + 31) >> 5
    excl = torch.cumsum(wlen, 0) - wlen
    tile = torch.arange(n, dtype=torch.int64, device=dev) // _TILE
    dest = excl - excl[tile * _TILE]                     # offset in its tile
    k = torch.arange(_CAP, dtype=torch.int64, device=dev)
    pos = dest[:, None] + k                              # (n, 54)
    keep = (k < wlen[:, None]) & (pos < tile_words)
    tiles = torch.empty(n_tiles * tile_words, dtype=torch.int32, device=dev)
    tiles[(tile[:, None] * tile_words + pos)[keep]] = bb_t.T[keep]
    return tiles.view(n_tiles, tile_words), blen


BLOCK_PACK_LIB = CudaLibrary("block_pack_kernel", {
    "uhdr_pack_blocks": [_PTR] * 4 + [_I64, _PTR],
    "uhdr_pack_tiles": [_PTR] * 4 + [_I64, _I64, _PTR]})


def _check_slots(what: str, pays: torch.Tensor, lens: torch.Tensor) -> int:
    """Raise unless pays and lens are contiguous 16-byte aligned (n, 72)
    int32 tensors on one CUDA device; returns n."""
    dev = pays.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    n = pays.shape[0] if pays.dim() == 2 else -1
    for name, t in (("pays", pays), ("lens", lens)):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (n, _SLOTS) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous 16-byte aligned "
                f"int32 (n, {_SLOTS}) tensor on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    return n


class _PackBlocksKernel:
    """Wrapper of uhdr_pack_blocks (csrc/block_pack_kernel.cu): launch,
    launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, pays: torch.Tensor, lens: torch.Tensor):
        n = _check_slots("block pack", pays, lens)
        out = self.buffers(n, pays.device)
        self.launch(pays, lens, *out)
        return out

    @staticmethod
    def buffers(n: int, dev: torch.device):
        """(bb_t (54, n), blen (n,)) int32 outputs for n blocks."""
        return (torch.empty((_CAP, n), dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    def launch(self, pays, lens, bb_t, blen):
        """The kernel alone on checked slots and buffers()."""
        lib = BLOCK_PACK_LIB.build()
        check_launch(lib, lib.uhdr_pack_blocks(
            pays.data_ptr(), lens.data_ptr(), bb_t.data_ptr(),
            blen.data_ptr(), pays.shape[0],
            torch.cuda.current_stream(pays.device).cuda_stream),
            "uhdr_pack_blocks")
        self.launches += 1


class _PackTilesKernel:
    """Wrapper of uhdr_pack_tiles (csrc/block_pack_kernel.cu): launch,
    launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, pays: torch.Tensor, lens: torch.Tensor, budget: int):
        n = _check_slots("tile pack", pays, lens)
        if not 1 <= budget <= _CAP:
            raise ValueError(f"tile pack: budget {budget} not in [1, {_CAP}]")
        out = self.buffers(n, budget, pays.device)
        self.launch(pays, lens, budget, *out)
        return out

    @staticmethod
    def buffers(n: int, budget: int, dev: torch.device):
        """(tiles (ceil(n / 2048), 2048 * budget), blen (n,)) int32 outputs
        for n blocks."""
        return (torch.empty((-(-n // _TILE), _TILE * budget),
                            dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    def launch(self, pays, lens, budget, tiles, blen):
        """The kernel alone on checked slots, budget and buffers()."""
        lib = BLOCK_PACK_LIB.build()
        check_launch(lib, lib.uhdr_pack_tiles(
            pays.data_ptr(), lens.data_ptr(), tiles.data_ptr(),
            blen.data_ptr(), pays.shape[0], _TILE * budget,
            torch.cuda.current_stream(pays.device).cuda_stream),
            "uhdr_pack_tiles")
        self.launches += 1


PACK_BLOCKS_KERNEL = _PackBlocksKernel()
PACK_TILES_KERNEL = _PackTilesKernel()


def pack_blocks(pays: torch.Tensor, lens: torch.Tensor):
    """Dispatcher of the block pack: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  No fallback between the two."""
    if pays.device.type == "cpu":
        return pack_blocks_plain(pays, lens)
    if pays.device.type == "cuda":
        return PACK_BLOCKS_KERNEL(pays, lens)
    raise unsupported(f"no block pack implementation for device "
                      f"{pays.device}")


def pack_tiles(pays: torch.Tensor, lens: torch.Tensor, budget: int):
    """Dispatcher of the tile pack: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  No fallback between the two."""
    if pays.device.type == "cpu":
        return pack_tiles_plain(pays, lens, budget)
    if pays.device.type == "cuda":
        return PACK_TILES_KERNEL(pays, lens, budget)
    raise unsupported(f"no tile pack implementation for device "
                      f"{pays.device}")


def compact_blocks_t(bb_t: torch.Tensor, blen: torch.Tensor,
                     w_out: int) -> torch.Tensor:
    """Block buffers (54, n) -> the (w_out,) int32 word stream: every
    block's ceil(blen/32) live words in block order, then zeros; words past
    w_out are dropped (the JAX ``compact_blocks_t``)."""
    wlen = (blen.to(torch.int64) + 31) >> 5
    keep = torch.arange(bb_t.shape[0], device=bb_t.device)[:, None] \
        < wlen[None, :]
    live = bb_t.T[keep.T]                                # block-major order
    out = torch.zeros(w_out, dtype=torch.int32, device=bb_t.device)
    m = min(w_out, live.numel())
    out[:m] = live[:m]
    return out


def tile_live_words(blen: torch.Tensor, n_blocks: int | None = None
                    ) -> torch.Tensor:
    """(n_tiles,) int32 live word count of each 2048-block tile of the
    first `n_blocks` block lengths (default: all of them)."""
    wlen = (blen[:n_blocks].to(torch.int64) + 31) >> 5
    wlen = torch.nn.functional.pad(wlen, (0, -wlen.shape[0] % _TILE))
    return wlen.view(-1, _TILE).sum(dim=1).to(torch.int32)


def stitch_tiles(parts) -> torch.Tensor:
    """Chain per-tile compacted buffers into one contiguous stream: parts =
    [(tiles (n_tiles, B), live (n_tiles,)), ...] -> the live prefixes of
    every tile in order, (sum of live,) int32.  (The JAX ``stitch_tiles``
    writes them into a buffer of the summed budgets and leaves the rest
    undefined.)"""
    out = []
    for tiles, live in parts:
        keep = torch.arange(tiles.shape[1], device=tiles.device)[None, :] \
            < live[:, None]
        out.append(tiles[keep])
    return torch.cat(out)


def check_tile_budgets(blen: np.ndarray, budget: int):
    """Host-side: every tile must fit its word budget (the tile pack drops
    the tail of an overflowing tile); raises PackOverflowError."""
    wlen = (np.asarray(blen).astype(np.int64) + 31) >> 5
    wlen = np.pad(wlen, (0, -wlen.size % _TILE))
    per_tile = wlen.reshape(-1, _TILE).sum(axis=1)
    limit = _TILE * budget
    if (per_tile > limit).any():
        raise de.PackOverflowError(
            f"tile needs {int(per_tile.max())} words > tile budget {limit}")


def block_buffers_kernel(coeff_planes, layout: de.ScanLayout):
    """One scan's block buffers through the block pack: (bb_t (54, n),
    blen (n,))."""
    return pack_blocks(*slots_for_kernel(coeff_planes, layout))
