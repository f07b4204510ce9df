"""Entropy decode of a baseline JPEG scan without restart markers, on the
card: the fused decode's Huffman stage for such scans.

The JAX package decodes every scan on the host (``libultrahdr_tpu/jpeg/
native.py`` ``decode_scan``); no Pallas kernel.  The port's own host
decoder (``native.decode_scan``) stays for every scan that this one does
not take.  As the other kernels of the port:

- a plain PyTorch version (``decode_plain``), which the CPU route runs and
  the CPU tests hold against ``native.decode_scan``, and which
  ``chip_smoke.py`` holds the kernel against on the card.  It runs the
  kernel's phases on tensors, one symbol of every subsequence a step: the
  unstuff, the sync rounds (a subsequence a lane, ``LANES`` lanes a group,
  each group agreeing within itself before the groups agree across), the
  prefix sums of the block counts and DC sums, the write and the status
  word;
- the wrapper of the hand-written CUDA kernel ``csrc/huffman_kernel.cu``
  (its header gives the design and what bounds it on the H100), built with
  nvcc for sm_90a at first use into ``_build/``, launched on PyTorch's
  current stream, raising on a refused launch, counting its launches
  (``HUFFMAN_KERNEL.launches``, one a scan) and the requests that the
  route decoded again on the host (``HUFFMAN_KERNEL.host_redecodes``);
- a dispatcher (``decode``): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, anything else raises.

Input: ``stage(data, offset, plan)``, the ``HEADER_BYTES`` header that
``plan`` (``scan_plan``) gives, then the scan's bytes from `offset` (the
byte after the SOS header) to the end of `data`.  Output: one
(mcus_h * v, mcus_w * h, 64) int16 zigzag plane a component, MCU-padded,
as ``native.decode_scan`` returns it, and a status word.  The status is 0
where the planes are ``native.decode_scan``'s bit for bit; a stream that
the host decodes only by its corrupt-data rules sets one of the ``ST_*``
bits, and the planes are then unspecified.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported

SUB_BITS = 1024       # bits a subsequence (a thread of the kernel)
ROUNDS = 16           # sync rounds across groups, at most (kRounds)
LANES = 128           # subsequences a group (a CTA of the kernel)
HEADER_BYTES = 4096
MAX_BLOCKS_PER_MCU = 16

# status bits (csrc/huffman_kernel.cu)
ST_NOT_SYNCED = 1     # the last sync round still changed a start
ST_BAD_CODE = 2       # no code matches, in a block written
ST_PAST_63 = 4        # a run past coefficient 63
ST_OUT_OF_BITS = 8    # a symbol runs past the data (its end or a marker)
ST_BLOCK_COUNT = 16   # blocks found != mcus * blocks an MCU
ST_STOPPED = 32       # a subsequence stopped before the last block
ST_PHASE = 64         # a block's place disagrees with its MCU


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """What the decoder needs of a parsed image besides its bytes."""
    mcus_w: int
    mcus_h: int
    comps: tuple          # (h, v) a component
    units: tuple          # (ci, by, bx, dc slot, ac slot) a block of an MCU
    slots: tuple          # (bits, values) a referenced table, DC ones first

    @property
    def blocks(self) -> int:
        return self.mcus_w * self.mcus_h * len(self.units)

    def shapes(self) -> list[tuple[int, int, int]]:
        return [(self.mcus_h * v, self.mcus_w * h, 64) for h, v in self.comps]


def _valid_table(bits, values, is_dc: bool) -> bool:
    """jpeg_entropy.cpp validate_dec_table: no code of all ones, at most
    256 symbols, DC symbols 0..15."""
    code = k = 0
    for length in range(1, 17):
        code += bits[length - 1]
        if code >= 1 << length:
            return False
        k += bits[length - 1]
        code <<= 1
    return k <= 256 and not (is_dc and any(v > 15 for v in values[:k]))


def scan_plan(info) -> ScanPlan | None:
    """The plan of a parsed baseline image (``decoder.parse_jpeg``), or
    None where the decoder does not take it: a progressive image, a restart
    interval, more than ``MAX_BLOCKS_PER_MCU`` blocks an MCU, or a
    referenced Huffman table missing or one that the host refuses (the
    host route then raises as it does)."""
    if info.progressive or info.restart_interval or not info.components:
        return None
    comps = info.components
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    slots: dict = {}
    for c in comps:
        for is_dc, idx in ((True, c.dc_tbl), (False, c.ac_tbl)):
            table = (info.dc_tables if is_dc else info.ac_tables).get(idx)
            if table is None or not _valid_table(table.bits, table.values,
                                                 is_dc):
                return None
            slots.setdefault((not is_dc, idx), table)
    keys = sorted(slots)        # DC tables first, then AC, by index
    slot_of = {key: i for i, key in enumerate(keys)}
    units = tuple((ci, by, bx, slot_of[(False, c.dc_tbl)],
                   slot_of[(True, c.ac_tbl)])
                  for ci, c in enumerate(comps)
                  for by in range(c.v) for bx in range(c.h))
    if len(units) > MAX_BLOCKS_PER_MCU or len(comps) > 4:
        return None
    return ScanPlan(mcus_w=-(-info.width // (8 * hmax)),
                    mcus_h=-(-info.height // (8 * vmax)),
                    comps=tuple((c.h, c.v) for c in comps), units=units,
                    slots=tuple((tuple(slots[k].bits), tuple(slots[k].values))
                                for k in keys))


def header(plan: ScanPlan) -> np.ndarray:
    """The kernel's header (csrc/huffman_kernel.cu ``Header``) as
    HEADER_BYTES bytes."""
    w = np.zeros(HEADER_BYTES // 4, np.int32)
    w[:5] = [len(plan.slots), len(plan.units), len(plan.comps), plan.mcus_w,
             plan.mcus_h]
    for ci, (h, v) in enumerate(plan.comps):
        w[8 + ci], w[12 + ci], w[16 + ci] = h, v, plan.mcus_w * h
    for u, unit in enumerate(plan.units):
        for field, value in enumerate(unit):    # ci, by, bx, dc, ac
            w[(64, 80, 96, 32, 48)[field] + u] = value
    b = w.view(np.uint8)
    for s, (bits, values) in enumerate(plan.slots):
        b[512 + 16 * s:528 + 16 * s] = bits
        b[640 + 256 * s:640 + 256 * s + len(values)] = values
    return b


def stage(data: bytes, offset: int, plan: ScanPlan,
          pin: bool = False) -> torch.Tensor:
    """The decoder's input: the header, then ``data[offset:]``, as one
    uint8 CPU tensor, in pinned memory with `pin` (one copy of the scan)."""
    scan = np.frombuffer(data, np.uint8)[offset:]
    out = torch.empty(HEADER_BYTES + scan.size, dtype=torch.uint8,
                      pin_memory=pin)
    o = out.numpy()
    o[:HEADER_BYTES] = header(plan)
    o[HEADER_BYTES:] = scan
    return out


# ---------------------------------------------------------------------------
# plain version

def _luts(plan: ScanPlan, dev) -> torch.Tensor:
    """(slots, 65536) int64: a slot's code in the 16 bits from a symbol's
    first, as length << 8 | symbol, 0 where no code matches (canonical
    codes are prefix-free, so this is the host's decode)."""
    lut = np.zeros((max(1, len(plan.slots)), 1 << 16), np.int64)
    for s, (bits, values) in enumerate(plan.slots):
        code = k = 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                lo = code << (16 - length)
                lut[s, lo:lo + (1 << (16 - length))] = \
                    (length << 8) | values[k]
                code += 1
                k += 1
            code <<= 1
    return torch.from_numpy(lut).to(dev)


def _unstuff(src: torch.Tensor) -> torch.Tensor:
    """The data bytes up to the first marker (an FF followed by anything
    but 00, or the last byte an FF), each 00 after an FF dropped, then 16
    zero bytes; int64."""
    n = src.numel()
    if n == 0:
        return src.new_zeros(16)
    nxt = torch.cat([src[1:], src.new_full((1,), -1)])
    prev = torch.cat([src.new_full((1,), -1), src[:-1]])
    marks = torch.nonzero((src == 0xFF) & (nxt != 0)).flatten()
    end = int(marks[0]) if marks.numel() else n
    keep = ((prev != 0xFF) | (src != 0))[:end]
    return torch.cat([src[:end][keep], src.new_zeros(16)])


class _Plain:
    """The plain decoder's state over one scan: the unstuffed bytes, the
    tables and the per-unit fields, and the symbol step over many lanes."""

    def __init__(self, src: torch.Tensor, plan: ScanPlan):
        dev = src.device
        self.data = _unstuff(src)
        self.nbits = 8 * (self.data.numel() - 16)
        self.lut = _luts(plan, dev)
        units = torch.tensor(plan.units, dtype=torch.int64, device=dev)
        self.ci, self.dc, self.ac = units[:, 0], units[:, 3], units[:, 4]
        self.bpm = len(plan.units)

    def peek(self, p: torch.Tensor) -> torch.Tensor:
        """32 bits from each bit p (p < nbits), big-endian."""
        byte = p >> 3
        v = torch.zeros_like(p)
        for i in range(5):
            v = (v << 8) | self.data[byte + i]
        return (v >> (8 - (p & 7))) & 0xFFFFFFFF

    def step(self, p, u, k):
        """One symbol of each lane: (status bit or 0, p, u, k, value,
        coefficient index or -1), the kernel's ``step``."""
        out = p >= self.nbits
        w = self.peek(torch.where(out, torch.zeros_like(p), p))
        dc = k == 0
        e = self.lut[torch.where(dc, self.dc[u], self.ac[u]), w >> 16]
        ln, sym = e >> 8, e & 0xFF
        s = torch.where(dc, sym, sym & 15)
        r = sym >> 4
        np_ = p + ln + s
        extra = ((w << ln) & 0xFFFFFFFF) >> (32 - s).clamp(max=31)
        extra = torch.where(s > 0, extra, torch.zeros_like(extra))
        half = torch.ones_like(s) << (s - 1).clamp(min=0)
        val = torch.where((s > 0) & (extra < half),
                          extra - (torch.ones_like(s) << s) + 1, extra)
        zrl = ~dc & (s == 0) & (r == 15)
        eob = ~dc & (s == 0) & (r != 15)
        coef = ~dc & (s > 0)
        nk = torch.where(dc, torch.ones_like(k),
                         torch.where(zrl, k + 16,
                                     torch.where(eob, torch.full_like(k, 64),
                                                 k + r)))
        past = (zrl & (nk > 64)) | (coef & (nk > 63))
        at = torch.where(coef, nk, torch.full_like(nk, -1))
        nk = torch.where(coef, nk + 1, nk)
        wrap = ~dc & (nk >= 64)
        nu = torch.where(wrap, (u + 1) % self.bpm, u)
        nk = torch.where(wrap, torch.zeros_like(nk), nk)
        code = torch.where(
            out, ST_OUT_OF_BITS, torch.where(
                ln == 0, ST_BAD_CODE, torch.where(
                    np_ > self.nbits, ST_OUT_OF_BITS,
                    torch.where(past, ST_PAST_63, 0))))
        return code, np_, nu, nk, val, at

    def run(self, lanes, start, S):
        """Each lane of `lanes` from its start (p, u, k) to the first symbol
        at or past its end: (exit p, u, k, blocks, DC sums (n, 4), err)."""
        p, u, k = (x.clone() for x in start)
        n = lanes.numel()
        end = (lanes + 1) * S
        cnt = torch.zeros_like(lanes)
        dcs = torch.zeros((n, 4), dtype=torch.int64, device=lanes.device)
        err = torch.zeros_like(lanes)
        live = p < end
        while bool(live.any()):
            a = torch.nonzero(live).flatten()
            code, np_, nu, nk, val, _ = self.step(p[a], u[a], k[a])
            bad, ok = a[code != 0], code == 0
            err[bad] = 1
            p[bad], u[bad], k[bad] = end[bad], 0, 0
            live[bad] = False
            g = a[ok]
            was_dc = k[g] == 0
            dcs[g[was_dc], self.ci[u[g[was_dc]]]] += val[ok][was_dc]
            cnt[g] += was_dc.to(cnt.dtype)
            p[g], u[g], k[g] = np_[ok], nu[ok], nk[ok]
            live[g] = p[g] < end[g]
        return p, u, k, cnt, dcs, err


def _state_eq(a, b) -> torch.Tensor:
    return (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])


def decode_plain(staged: torch.Tensor, plan: ScanPlan,
                 sub_bits: int = SUB_BITS):
    """Plain PyTorch version (any device): (planes, status (1,) int32)."""
    if sub_bits < 32:
        raise ValueError(f"huffman decode: sub_bits {sub_bits} < 32")
    dev = staged.device
    src = staged[HEADER_BYTES:].to(torch.int64)
    dec = _Plain(src, plan)
    n_lanes = max(1, -(-src.numel() * 8 // sub_bits))
    lanes = torch.arange(n_lanes, device=dev)
    first_of_group = lanes % LANES == 0
    zeros = torch.zeros_like(lanes)
    st = [lanes * sub_bits, zeros.clone(), zeros.clone()]
    ex_p, ex_u, ex_k, cnt, dcs, err = dec.run(lanes, st, sub_bits)
    ex = [ex_p, ex_u, ex_k]

    def redo(sel):
        got = dec.run(lanes[sel], [s[sel] for s in st], sub_bits)
        for i in range(3):
            ex[i][sel] = got[i]
        cnt[sel], dcs[sel], err[sel] = got[3], got[4], got[5]

    def agree_within_groups():
        while True:
            new = [torch.cat([x.new_zeros(1), x[:-1]]) for x in ex]
            moved = ~first_of_group & ~_state_eq(new, st)
            if not bool(moved.any()):
                return
            sel = torch.nonzero(moved).flatten()
            for i in range(3):
                st[i][sel] = new[i][sel]
            redo(sel)

    agree_within_groups()
    changed = True      # round 0
    for _ in range(1, ROUNDS):
        if not changed:
            break
        heads = torch.nonzero(first_of_group & (lanes > 0)).flatten()
        incoming = [x[heads - 1] for x in ex]
        moved = ~_state_eq(incoming, [s[heads] for s in st])
        changed = bool(moved.any())
        if changed:
            sel = heads[moved]
            for i in range(3):
                st[i][sel] = incoming[i][moved]
            redo(sel)
            agree_within_groups()
    # the scan: each subsequence's first block and DC predictors
    first = torch.cumsum(cnt, 0) - cnt
    pred = torch.cumsum(dcs, 0) - dcs
    expected = plan.blocks
    status = 0
    if int(cnt.sum()) != expected:
        status |= ST_BLOCK_COUNT
    if changed:
        status |= ST_NOT_SYNCED
    if bool((err.bool() & (first + cnt < expected)).any()):
        status |= ST_STOPPED
    flat = torch.empty(sum(int(np.prod(s)) for s in plan.shapes()),
                       dtype=torch.int16, device=dev)
    if status == 0:
        status = _write_plain(dec, plan, flat, st, cnt, first, pred)
    planes, o = [], 0
    for shape in plan.shapes():
        size = int(np.prod(shape))
        planes.append(flat[o:o + size].view(shape))
        o += size
    return planes, torch.tensor([status], dtype=torch.int32, device=dev)


def _block_offsets(plan: ScanPlan, gb: torch.Tensor) -> torch.Tensor:
    """The flat offset (in the planes laid back to back) of blocks gb."""
    units = torch.tensor(plan.units, dtype=torch.int64, device=gb.device)
    bpm = len(plan.units)
    base, o = [], 0
    for shape in plan.shapes():
        base.append(o)
        o += int(np.prod(shape))
    h = torch.tensor([c[0] for c in plan.comps], device=gb.device)
    v = torch.tensor([c[1] for c in plan.comps], device=gb.device)
    base = torch.tensor(base, device=gb.device)
    m, ub = gb // bpm, gb % bpm
    ci = units[ub, 0]
    row = (m // plan.mcus_w) * v[ci] + units[ub, 1]
    col = (m % plan.mcus_w) * h[ci] + units[ub, 2]
    return base[ci] + (row * plan.mcus_w * h[ci] + col) * 64


def _write_plain(dec: _Plain, plan: ScanPlan, flat, st, cnt, first,
                 pred) -> int:
    """The write pass: each lane with blocks decodes them whole from its
    synced start into `flat`; returns the status bits it meets."""
    sel = torch.nonzero(cnt > 0).flatten()
    p, u, k = (s[sel].clone() for s in st)
    n, gb0, pred = cnt[sel], first[sel], pred[sel].clone()
    done = torch.zeros_like(n)
    expected = plan.blocks
    status = 0
    # the tail of the block started to the left
    live = k != 0
    stopped = torch.zeros_like(live)
    while bool(live.any()):
        a = torch.nonzero(live).flatten()
        code, np_, nu, nk, _, _ = dec.step(p[a], u[a], k[a])
        for c in torch.unique(code[code != 0]).tolist():
            status |= int(c)
        stopped[a] = code != 0
        p[a], u[a], k[a] = np_, nu, nk
        live[a] = (nk != 0) & (code == 0)
    live = (gb0 < expected) & ~stopped
    offs = torch.zeros_like(n)
    while bool(live.any()):
        a = torch.nonzero(live).flatten()
        at_dc = k[a] == 0
        gb = gb0[a] + done[a]
        phase = at_dc & (gb % dec.bpm != u[a])
        if bool(phase.any()):
            status |= ST_PHASE
            live[a[phase]] = False
            continue
        starts = a[at_dc]
        if starts.numel():
            offs[starts] = _block_offsets(plan, gb[at_dc])
            flat[(offs[starts, None]
                  + torch.arange(64, device=flat.device)).flatten()] = 0
        ci = dec.ci[u[a]]
        code, np_, nu, nk, val, at = dec.step(p[a], u[a], k[a])
        for c in torch.unique(code[code != 0]).tolist():
            status |= int(c)
        ok = code == 0
        live[a[~ok]] = False
        a, ci, val, at, at_dc = a[ok], ci[ok], val[ok], at[ok], at_dc[ok]
        np_, nu, nk = np_[ok], nu[ok], nk[ok]
        d = a[at_dc]
        pred[d, ci[at_dc]] += val[at_dc]
        dcv = pred[d, ci[at_dc]] & 0xFFFF
        flat[offs[d]] = ((dcv ^ 0x8000) - 0x8000).to(torch.int16)
        c = at >= 0
        flat[offs[a[c]] + at[c]] = val[c].to(torch.int16)
        p[a], u[a], k[a] = np_, nu, nk
        ended = ~at_dc & (nk == 0)
        done[a[ended]] += 1
        live[a] = (done[a] < n[a]) & (gb0[a] + done[a] < expected)
    return status


# ---------------------------------------------------------------------------
# the kernel

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
HUFFMAN_LIB = CudaLibrary("huffman_kernel", {
    "uhdr_huffman_decode": [_PTR, _I64, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                            _PTR, _INT, _PTR]})


class _HuffmanKernel:
    """Wrapper of uhdr_huffman_decode: checks, launch, launch count, and
    the count of requests that the route decoded again on the host."""

    def __init__(self):
        self.launches = 0
        self.host_redecodes = 0

    @staticmethod
    def check(staged: torch.Tensor, plan: ScanPlan, planes, status):
        """Raise unless the inputs are what the kernel reads."""
        dev = staged.device
        if dev.type != "cuda":
            raise ValueError(f"huffman kernel needs CUDA tensors, got {dev}")
        if staged.dtype != torch.uint8 or staged.dim() != 1 \
                or not staged.is_contiguous() \
                or staged.numel() < HEADER_BYTES or staged.data_ptr() % 16:
            raise ValueError("huffman kernel: staged must be a contiguous, "
                             "16-byte aligned uint8 vector holding the "
                             "header and the scan")
        if len(planes) != len(plan.comps):
            raise ValueError(f"huffman kernel: {len(plan.comps)} planes "
                             f"needed, got {len(planes)}")
        for p, shape in zip(planes, plan.shapes()):
            if p.device != dev or p.dtype != torch.int16 \
                    or tuple(p.shape) != shape or not p.is_contiguous() \
                    or p.data_ptr() % 16:
                raise ValueError(f"huffman kernel: a plane must be a "
                                 f"contiguous 16-byte aligned int16 {shape} "
                                 f"tensor on {dev}")
        if status.device != dev or status.dtype != torch.int32 \
                or status.numel() != 1:
            raise ValueError(f"huffman kernel: status must be one int32 on "
                             f"{dev}")

    def launch(self, staged, plan: ScanPlan, planes, status,
               sub_bits: int = SUB_BITS):
        """The kernel alone on checked inputs."""
        lib = HUFFMAN_LIB.build()
        dev = staged.device
        n = staged.numel() - HEADER_BYTES
        size = lib.uhdr_huffman_scratch_bytes   # returns int64, so bound
        size.argtypes, size.restype = [_I64, _INT], _I64   # here, not
        nbytes = size(n, sub_bits)                         # as an entry
        if nbytes < 0:
            raise ValueError(f"huffman kernel: sub_bits {sub_bits} < 32")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
        check_launch(lib, lib.uhdr_huffman_decode(
            staged.data_ptr(), n, plan.blocks, *ptrs, scratch.data_ptr(),
            status.data_ptr(), sub_bits,
            torch.cuda.current_stream(dev).cuda_stream),
            "uhdr_huffman_decode")
        self.launches += 1

    def __call__(self, staged: torch.Tensor, plan: ScanPlan,
                 status: torch.Tensor | None = None,
                 sub_bits: int = SUB_BITS):
        dev = staged.device
        planes = [torch.empty(s, dtype=torch.int16, device=dev)
                  for s in plan.shapes()]
        if status is None:
            status = torch.empty(1, dtype=torch.int32, device=dev)
        self.check(staged, plan, planes, status)
        self.launch(staged, plan, planes, status, sub_bits)
        return planes, status


HUFFMAN_KERNEL = _HuffmanKernel()


def decode(staged: torch.Tensor, plan: ScanPlan,
           status: torch.Tensor | None = None, sub_bits: int = SUB_BITS):
    """Dispatcher: the plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor (its status word into `status` when given); (planes,
    status).  No fallback."""
    if staged.device.type == "cpu":
        return decode_plain(staged, plan, sub_bits)
    if staged.device.type == "cuda":
        return HUFFMAN_KERNEL(staged, plan, status, sub_bits)
    raise unsupported(f"no huffman decode for device {staged.device}")
