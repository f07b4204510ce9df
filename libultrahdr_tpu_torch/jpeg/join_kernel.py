"""The restart-row join of a fused encode's scans, on the card.

No TPU kernel is replaced: the JAX package joins a scan's word-aligned block
segments on the host (``uhdr_join_blocks``, C++, through
``native.join_blocks``), and so do the port's pipelined, K-batch and sharded
encodes, whose words reach the host by other paths.  The fused
single-request encode (``fused._pack_and_assemble``) joins on the device,
through this module's trio, as the port's other kernels:

- a plain PyTorch version (``join_scans_plain``), vectorized over bits and
  bytes, which the CPU route runs and the CPU tests hold against
  ``native.join_blocks``, and which ``chip_smoke.py`` holds the kernel
  against on the card;
- the wrapper of the hand-written CUDA kernel ``csrc/join_kernel.cu`` (its
  header gives the design and what bounds it on the H100), built with nvcc
  for sm_90a at first use into ``_build/``, launched on PyTorch's current
  stream, raising on a refused launch, counting its launches
  (``JOIN_KERNEL.launches``, one a call: a pass of five launches over every
  scan given), split into ``buffers()`` and ``launch()``;
- a dispatcher (``join_scans``): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, anything else raises.  Nothing falls back.

Input: the pack's outputs as they stand (``pack_kernel``: `words` int32
holding u32 patterns, block b's MSB-first bits at the exclusive prefix sum
of ceil(blen/32), `blen` (n,) int32 with no restart-row pad) and `parts`,
[(blocks, blocks a row), ...] of the scans packed back to back, in packing
order.  Output: (out uint8, sizes (len(parts),) int64) on the input's
device: scan s's bytes are out[sum(sizes[:s]):sum(sizes[:s + 1])], each
equal byte for byte to ``native.join_blocks`` on its words and lengths:
the rows' bits concatenated, each row padded to a byte with 1-bits, 0x00
stuffed after every 0xFF byte (pad bytes included), FF D0+(r & 7) after
every row but the scan's last.  The kernel's `out` is sized from the block
count alone, so that nothing is read before its launch: a caller waits for
the stream, then reads `sizes`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported
from .pack_kernel import CAP_WORDS

MAX_SCANS = 8          # kMaxScans of csrc/join_kernel.cu
MAX_BPR = 8192         # kMaxBpr: blocks a row (an 8192-pixel row has 3,072)
_FIELDS = 5            # int64 scratch words a row (kFields)


def _check_parts(n: int, parts) -> list[tuple[int, int]]:
    """Raise unless `parts` cover the n blocks in whole rows."""
    parts = [(int(nb), int(bpr)) for nb, bpr in parts]
    if not parts or any(bpr < 1 or nb < 0 or nb % bpr for nb, bpr in parts):
        raise ValueError(f"join: every part needs whole rows of at least "
                         f"one block, got {parts}")
    if sum(nb for nb, _ in parts) != n:
        raise ValueError(f"join: parts cover {sum(nb for nb, _ in parts)} "
                         f"blocks, blen has {n}")
    return parts


def join_scans_plain(words: torch.Tensor, blen: torch.Tensor, parts):
    """Plain version of the join (any device): every live bit of every block
    placed at its row's bit offset after the pad bytes of the rows before
    it, the bytes read off in eights, then each byte and marker written at
    its stuffed place (an exclusive prefix sum of 1 + (byte == 0xFF) and of
    the markers before its row).  Returns (out, sizes) with out exactly
    sum(sizes) bytes."""
    dev = words.device
    n = blen.numel()
    parts = _check_parts(n, parts)
    i64 = dict(dtype=torch.int64, device=dev)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bl = blen.to(torch.int64)
    # rows numbered across the scans; a marker after all but a scan's last
    row_of_block, in_scan, marks, ends = [], [], [], []
    rows = 0
    for nb, bpr in parts:
        r = nb // bpr
        row_of_block.append(torch.arange(nb, **i64) // bpr + rows)
        in_scan.append(torch.arange(r, **i64))
        m = torch.full((r,), 2, **i64)
        m[-1:] = 0
        marks.append(m)
        rows += r
        ends.append(rows)
    row_of_block = torch.cat(row_of_block)
    in_scan, marks = torch.cat(in_scan), torch.cat(marks)
    # every live bit, MSB first, in stream order
    wlen = (bl + 31) >> 5
    first_word = torch.cumsum(wlen, 0) - wlen
    first_bit = torch.cumsum(bl, 0) - bl
    blk = torch.repeat_interleave(torch.arange(n, **i64), bl)
    t = torch.arange(blk.numel(), **i64) - first_bit[blk]
    bits = (w[first_word[blk] + (t >> 5)] >> (31 - (t & 31))) & 1
    # each row padded to whole bytes with 1-bits
    row_bits = torch.zeros(rows, **i64).index_add_(0, row_of_block, bl)
    row_bytes = (row_bits + 7) >> 3
    pad = 8 * row_bytes - row_bits
    pad_before = torch.cumsum(pad, 0) - pad
    padded = torch.ones(8 * int(row_bytes.sum()), dtype=torch.uint8,
                        device=dev)
    padded[torch.arange(bits.numel(), **i64)
           + pad_before[row_of_block[blk]]] = bits.to(torch.uint8)
    byte = (padded.view(-1, 8).to(torch.int64)
            << torch.arange(7, -1, -1, **i64)).sum(dim=1)
    # stuffing and markers
    byte_row = torch.repeat_interleave(torch.arange(rows, **i64), row_bytes)
    size = 1 + (byte == 0xFF).to(torch.int64)
    marks_before = torch.cumsum(marks, 0) - marks
    pos = torch.cumsum(size, 0) - size + marks_before[byte_row]
    row_len = torch.zeros(rows, **i64).index_add_(0, byte_row, size) + marks
    row_end = torch.cumsum(row_len, 0)
    out = torch.zeros(int(row_len.sum()), dtype=torch.uint8, device=dev)
    out[pos] = byte.to(torch.uint8)
    at = (row_end - marks)[marks > 0]
    out[at] = 0xFF
    out[at + 1] = (0xD0 + (in_scan[marks > 0] & 7)).to(torch.uint8)
    scan_end = torch.cat([torch.zeros(1, **i64), row_end])[
        torch.tensor([0] + ends, device=dev)]
    return out, scan_end[1:] - scan_end[:-1]


_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
JOIN_LIB = CudaLibrary("join_kernel", {
    "uhdr_join_scans": [_PTR, _PTR, _INT, _PTR, _PTR, _I64, _PTR, _PTR,
                        _I64, _PTR, _PTR]})


class _JoinKernel:
    """Wrapper of csrc/join_kernel.cu: checks, buffers, launch, launch
    count."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def setup():
        """Build the kernel (it happens at first use otherwise)."""
        JOIN_LIB.build()

    def __call__(self, words: torch.Tensor, blen: torch.Tensor, parts):
        parts = self.check(words, blen, parts)
        out = self.buffers(words, parts)
        self.launch(words, blen, parts, *out)
        _, data, sizes = out
        return data, sizes

    @staticmethod
    def check(words: torch.Tensor, blen: torch.Tensor, parts):
        """Raise unless the inputs are what the kernel reads; returns the
        parts as (blocks, blocks a row) ints."""
        dev = words.device
        if dev.type != "cuda":
            raise ValueError(f"join kernel needs CUDA tensors, got {dev}")
        for name, t, dtype in (("words", words, torch.int32),
                               ("blen", blen, torch.int32)):
            if (t.device != dev or t.dtype != dtype or t.dim() != 1
                    or not t.is_contiguous()):
                raise ValueError(
                    f"join kernel: {name} must be a contiguous 1-D {dtype} "
                    f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        parts = _check_parts(blen.numel(), parts)
        if len(parts) > MAX_SCANS or max(b for _, b in parts) > MAX_BPR:
            raise ValueError(f"join kernel: at most {MAX_SCANS} scans of at "
                             f"most {MAX_BPR} blocks a row, got {parts}")
        return parts

    @staticmethod
    def buffers(words: torch.Tensor, parts):
        """(scratch, out, sizes): the int64 scratch (5 words a row), room
        for the scans' bytes (8 a word the pack can have written, at most
        CAP_WORDS a block: a row's bytes are at most 4 a word, and stuffing
        at most doubles them; 2 a row for the markers) and the zeroed
        sizes."""
        dev = words.device
        n = sum(nb for nb, _ in parts)
        rows = sum(nb // bpr for nb, bpr in parts)
        cap = 8 * min(words.numel(), n * CAP_WORDS) + 2 * rows
        return (torch.empty(_FIELDS * rows, dtype=torch.int64, device=dev),
                torch.empty(cap, dtype=torch.uint8, device=dev),
                torch.zeros(len(parts), dtype=torch.int64, device=dev))

    def launch(self, words, blen, parts, scratch, out, sizes):
        """The kernel alone on checked inputs and buffers()."""
        lib = JOIN_LIB.build()
        blocks = np.array([nb for nb, _ in parts], np.int64)
        bpr = np.array([b for _, b in parts], np.int64)
        check_launch(lib, lib.uhdr_join_scans(
            words.data_ptr(), blen.data_ptr(), len(parts),
            blocks.ctypes.data, bpr.ctypes.data, scratch.numel(),
            scratch.data_ptr(), out.data_ptr(), out.numel(),
            sizes.data_ptr(),
            torch.cuda.current_stream(words.device).cuda_stream),
            "uhdr_join_scans")
        self.launches += 1


JOIN_KERNEL = _JoinKernel()


def join_scans(words: torch.Tensor, blen: torch.Tensor, parts):
    """Dispatcher: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  No fallback between the two."""
    if words.device.type == "cpu":
        return join_scans_plain(words, blen, parts)
    if words.device.type == "cuda":
        return JOIN_KERNEL(words, blen, parts)
    raise unsupported(f"no join implementation for device {words.device}")


def scan_bytes(out: np.ndarray, sizes) -> list[bytes]:
    """Each scan's bytes of a join's output on the host."""
    ends = np.cumsum(sizes)
    return [out[e - s:e].tobytes() for s, e in zip(sizes, ends)]
