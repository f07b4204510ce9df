"""The wire codecs' two device kernels: the un-slicing of the bit-sliced
upload wires and the download wire's pack.

The JAX package computes both with XLA ops in ``libultrahdr_tpu/fused.py``
(``_vw_unslice``, the unslice of ``_delta_decode_plane`` and
``_unpack_one_n``; ``_down_delta_sections`` with
``_pack_down_wire_1010102`` / ``_pack_down_wire_f16``); neither has a Pallas
twin.  Each is, as the other kernels of the port:

- a plain PyTorch version (``unslice_plain``, ``down_pack_plain``), the JAX
  ops transcribed, which the CPU tests hold against the JAX package and
  ``chip_smoke.py`` holds the kernel against on the card (``torch.equal``);
- the wrapper of the hand-written CUDA kernel ``csrc/wire_kernel.cu`` (its
  header gives the design and what bounds it on the H100), built with nvcc
  for sm_90a at first use into ``_build/``, launched on PyTorch's current
  stream, raising on a refused launch, counting its launches
  (``UNSLICE_KERNEL.launches``, ``DOWN_PACK_KERNEL.launches``: one a call,
  the download pack's two launches counted as one);
- a dispatcher (``unslice``, ``down_pack``): a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, anything else raises.  Nothing
  falls back: a failed build or launch propagates.

Carriers: u32 words are int32 tensors holding their bit patterns; the
packed RGBA1010102 output an (H, W) int32 tensor, RGBAF16 an (H, W, 4) int16
tensor (``ops/pixel.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .._buildlib import CudaLibrary, check_launch
from ..errors import unsupported

VW_MAX_WIDTH = 12      # the JAX package's _VW_MAXW: widths above read 12 words
DOWN_ESC = 8192        # the JAX package's _DOWN_ESC


def _groups(n: int) -> int:
    return -(-n // 32)


def _to_i32(words64: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> their int32 bit patterns."""
    return torch.where(words64 >= 1 << 31, words64 - (1 << 32),
                       words64).to(torch.int32)


def unslice_plain(payload: torch.Tensor, n: int, *, bits: int = 0,
                  widths: torch.Tensor | None = None,
                  offsets: torch.Tensor | None = None) -> torch.Tensor:
    """The first n samples of a bit-sliced wire as int32, bias removed.

    Fixed rung (`bits`, no widths): group g's words are payload[g * bits:
    (g + 1) * bits] and the bias 1 << (bits - 1) (the JAX
    ``_delta_decode_plane`` and ``_unpack_one_n``).  Variable-width wire
    (`widths`, `offsets`: (G,) int32, offsets = cumsum(widths) - widths):
    group g's words start at offsets[g], at most 12 read, word indices
    clipped to the payload, the bias 1 << (w - 1) for w > 0, else 0 (the
    JAX ``_vw_unslice``)."""
    dev = payload.device
    lanes = torch.arange(32, dtype=torch.int32, device=dev)[None, :]
    if widths is None:
        g = _groups(n)
        words = payload[:g * bits].reshape(g, bits)
        nb = bits
        bias = torch.full((g,), 1 << (bits - 1), dtype=torch.int32,
                          device=dev)
    else:
        idx = offsets[:, None] + torch.arange(VW_MAX_WIDTH, dtype=torch.int32,
                                              device=dev)[None, :]
        words = payload[torch.clamp(idx, 0, payload.shape[0] - 1).long()]
        words = torch.where(
            torch.arange(VW_MAX_WIDTH, device=dev)[None, :] < widths[:, None],
            words, torch.zeros_like(words))
        nb = VW_MAX_WIDTH
        bias = torch.where(widths > 0, torch.ones_like(widths)
                           << torch.clamp(widths - 1, min=0),
                           torch.zeros_like(widths))
    s = torch.zeros((words.shape[0], 32), dtype=torch.int32, device=dev)
    for b in range(nb):
        s = s | (((words[:, b:b + 1] >> lanes) & 1) << b)
    return (s - bias[:, None]).reshape(-1)[:n]


def _down_channels(packed: torch.Tensor):
    """The three channels of a packed output as (H, W) int32: RGBA1010102
    (H, W) int32 -> (packed >> 10c) & 0x3FF; RGBAF16 (H, W, 4) int16 -> the
    u16 pattern of channel c."""
    if packed.dim() == 2:
        return [(packed >> s) & 0x3FF for s in (0, 10, 20)]
    return [packed[..., c].to(torch.int32) & 0xFFFF for c in range(3)]


def down_delta_sections(ch: torch.Tensor, bits: int, cap: int, base: int):
    """One (h, w) int32 channel -> (words (G*bits,) int32 carrier of u32,
    esc_idx (cap,) int32, esc_val (cap,) int32, count): the JAX
    ``_down_delta_sections``, the device mirror of the host encoder
    uhdr_pack_delta_g (vertical diff from `base`, then horizontal diff
    restarting at 0 each row); codes = delta + half, an escape outside [0,
    2^bits) coded half, the first cap escape indices in ascending order
    padded with n, their deltas padded with 0; count counts every escape."""
    n = ch.numel()
    dev = ch.device
    half = 1 << (bits - 1)
    t = torch.cat([ch[:1] - base, ch[1:] - ch[:-1]], dim=0)
    d = torch.cat([t[:, :1], t[:, 1:] - t[:, :-1]], dim=1).reshape(-1)
    code = d + half
    oob = (code < 0) | (code >= (1 << bits))
    where = torch.nonzero(oob).reshape(-1)
    k = min(where.numel(), cap)
    idx = torch.full((cap,), n, dtype=torch.int32, device=dev)
    val = torch.zeros(cap, dtype=torch.int32, device=dev)
    idx[:k] = where[:k].to(torch.int32)
    val[:k] = d[where[:k]]
    codeu = torch.where(oob, torch.full_like(code, half), code)
    pad = (-n) % 32
    if pad:
        codeu = torch.cat([codeu, torch.full((pad,), half, dtype=torch.int32,
                                             device=dev)])
    grp = codeu.reshape(-1, 32).to(torch.int64)
    lanes = torch.arange(32, dtype=torch.int64, device=dev)[None, :]
    words = torch.stack([(((grp >> j) & 1) << lanes).sum(dim=1)
                         for j in range(bits)], dim=1).reshape(-1)
    return _to_i32(words), idx, val, where.numel()


def down_pack_plain(packed: torch.Tensor, *, bits: int, cap: int = DOWN_ESC,
                    base: int = 512) -> torch.Tensor:
    """The download wire of a packed output, as the JAX
    ``_pack_down_wire_1010102`` / ``_pack_down_wire_f16``: per channel
    [words][cap escape indices][cap escape values]
    (``down_delta_sections``), then the three escape counts; one int32
    tensor of u32 patterns."""
    secs, counts = [], []
    for ch in _down_channels(packed):
        words, idx, val, cnt = down_delta_sections(ch, bits, cap, base)
        secs += [words, idx, val]
        counts.append(cnt)
    return torch.cat(secs + [torch.tensor(counts, dtype=torch.int32,
                                          device=packed.device)])


_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
WIRE_LIB = CudaLibrary("wire_kernel", {
    "uhdr_wire_unslice": [_PTR, _I64, _PTR, _PTR, ctypes.c_int, _I64, _I64,
                          _PTR, _PTR],
    "uhdr_down_pack": [_PTR, ctypes.c_int, _I64, _I64, ctypes.c_int, _I64,
                       ctypes.c_int, _PTR, _PTR, _PTR]})
# samples a CTA of uhdr_down_pack takes (csrc/wire_kernel.cu kTile)
DOWN_TILE = 8192


def _check(name: str, t: torch.Tensor, dtype, dev, shape=None):
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != shape)):
        raise ValueError(f"wire kernel: {name} must be a contiguous {dtype} "
                         f"tensor{'' if shape is None else f' {shape}'} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


class _UnsliceKernel:
    """Wrapper of uhdr_wire_unslice: checks, launch, launch count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, payload: torch.Tensor, n: int, *, bits: int = 0,
                 widths: torch.Tensor | None = None,
                 offsets: torch.Tensor | None = None) -> torch.Tensor:
        dev = payload.device
        if dev.type != "cuda":
            raise ValueError(f"unslice kernel needs CUDA tensors, got {dev}")
        _check("payload", payload, torch.int32, dev)
        if widths is None:
            g = _groups(n)
            if not 1 <= bits <= 31 or payload.numel() < g * bits:
                raise ValueError(f"unslice kernel: {payload.numel()} words "
                                 f"for {g} groups of {bits} bits")
        else:
            g = widths.numel()
            _check("widths", widths, torch.int32, dev, (g,))
            _check("offsets", offsets, torch.int32, dev, (g,))
            if n > 32 * g or payload.numel() == 0:
                raise ValueError(f"unslice kernel: {n} samples from {g} "
                                 f"groups and {payload.numel()} words")
        lib = WIRE_LIB.build()
        out = torch.empty(n, dtype=torch.int32, device=dev)
        check_launch(lib, lib.uhdr_wire_unslice(
            payload.data_ptr(), payload.numel(),
            None if widths is None else widths.data_ptr(),
            None if widths is None else offsets.data_ptr(), int(bits), g, n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "uhdr_wire_unslice")
        self.launches += 1
        return out


class _DownPackKernel:
    """Wrapper of uhdr_down_pack: checks, the wire buffer and the CTA
    counts' scratch, the two launches, one count a call."""

    def __init__(self):
        self.launches = 0

    def __call__(self, packed: torch.Tensor, *, bits: int,
                 cap: int = DOWN_ESC, base: int = 512) -> torch.Tensor:
        dev = packed.device
        if dev.type != "cuda":
            raise ValueError(f"down-pack kernel needs CUDA tensors, got {dev}")
        f16 = packed.dim() == 3
        h, w = packed.shape[:2]
        _check("packed", packed, torch.int16 if f16 else torch.int32, dev,
               (h, w, 4) if f16 else (h, w))
        if f16 and packed.data_ptr() % 8:
            raise ValueError("down-pack kernel: an RGBAF16 output must be "
                             "8-byte aligned")
        if not 2 <= bits <= 8 or cap < 1:
            raise ValueError(f"down-pack kernel: bits {bits}, cap {cap}")
        lib = WIRE_LIB.build()
        g = _groups(h * w)
        wire = torch.empty(3 * (g * bits + 2 * cap) + 3, dtype=torch.int32,
                           device=dev)
        blocks = -(-g * 32 // DOWN_TILE)
        scratch = torch.empty(3 * max(blocks, 1), dtype=torch.int32,
                              device=dev)
        check_launch(lib, lib.uhdr_down_pack(
            packed.data_ptr(), int(f16), h, w, int(bits), int(cap),
            int(base), wire.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "uhdr_down_pack")
        self.launches += 1
        return wire


UNSLICE_KERNEL = _UnsliceKernel()
DOWN_PACK_KERNEL = _DownPackKernel()


def unslice(payload: torch.Tensor, n: int, *, bits: int = 0,
            widths: torch.Tensor | None = None,
            offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatcher of the un-slicing (see ``unslice_plain``): the plain
    version for CPU tensors, the kernel for CUDA tensors, no fallback."""
    kw = dict(bits=bits, widths=widths, offsets=offsets)
    if payload.device.type == "cpu":
        return unslice_plain(payload, n, **kw)
    if payload.device.type == "cuda":
        return UNSLICE_KERNEL(payload, n, **kw)
    raise unsupported(f"no unslice implementation for device "
                      f"{payload.device}")


def down_pack(packed: torch.Tensor, *, bits: int, cap: int = DOWN_ESC,
              base: int = 512) -> torch.Tensor:
    """Dispatcher of the download wire's pack (see ``down_pack_plain``):
    the plain version for CPU tensors, the kernel for CUDA tensors, no
    fallback."""
    if packed.device.type == "cpu":
        return down_pack_plain(packed, bits=bits, cap=cap, base=base)
    if packed.device.type == "cuda":
        return DOWN_PACK_KERNEL(packed, bits=bits, cap=cap, base=base)
    raise unsupported(f"no download-pack implementation for device "
                      f"{packed.device}")
