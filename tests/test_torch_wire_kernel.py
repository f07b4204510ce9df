"""The wire kernels' contract, on the CPU.

``csrc/wire_kernel.cu`` holds two kernels that run only on the card, where
``chip_smoke.py`` phase 18 holds them against their plain versions bit for
bit.  Here:

- numpy models of both, written from the source: ``uhdr_wire_unslice``
  (a warp a group, lane l taking bit l of each of the group's words, at
  most 12 words, word indices clamped to the payload, the bias by width)
  and ``uhdr_down_pack`` (launch (a): CTAs of 8,192 samples in 32 steps of
  256, a warp's 32 samples one group, one ballot a word, each CTA's escape
  counts; launch (b): each CTA's exclusive prefix and the total, the
  padding from the total to cap, the escapes ranked by ballot and the
  warps' counts and stored below cap), each equal to the plain version on
  phase 18's edge cases: fixed rungs of 2-8 bits, vw widths 0-15, sample
  counts that are no multiple of 32, a payload shorter than its offsets;
  both download formats at 3, 4, 6 and 8 bits, escapes at the first and
  last sample, counts above cap, outputs that span several CTAs;
- the dispatchers never fall back: a CPU tensor takes the plain version
  and counts no launch, the kernel wrappers refuse CPU tensors, another
  device raises, a CUDA request without a GPU raises, and a kernel that
  does not build raises without running the plain version.
"""

import types

import numpy as np
import pytest
import torch

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import _buildlib, fused, testing, wire
from libultrahdr_tpu_torch.ops import wire_kernel as wk

TILE, THREADS = 8192, 256


def _words(rs, n) -> np.ndarray:
    return rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)


def unslice_model(payload: np.ndarray, n: int, bits: int = 0, widths=None):
    """uhdr_wire_unslice: one warp a group, lane l sample 32 g + l."""
    p = payload.view(np.uint32)
    groups = -(-n // 32) if widths is None else widths.size
    offsets = None if widths is None else np.cumsum(widths) - widths
    out = np.zeros(n, np.int32)
    for g in range(groups):
        if widths is None:
            w, o, bias = bits, g * bits, 1 << (bits - 1)
            words = bits
        else:
            w, o = int(widths[g]), int(offsets[g])
            words, bias = min(w, 12), (1 << (w - 1)) if w > 0 else 0
        s = np.zeros(32, np.uint32)
        for j in range(words):
            word = p[min(max(o + j, 0), p.size - 1)]
            s |= ((word >> np.arange(32, dtype=np.uint32)) & 1) << j
        lanes = np.arange(32)
        keep = g * 32 + lanes < n
        out[g * 32 + lanes[keep]] = s[keep].astype(np.int64) - bias
    return out


def _channels(packed: np.ndarray, p: int):
    """The kernel's `channels`: the three samples of pixel p."""
    if packed.ndim == 3:
        px = packed.reshape(-1, 4)[p].view(np.uint16)
        return [int(px[c]) for c in range(3)]
    v = int(packed.reshape(-1)[p].view(np.uint32))
    return [v & 0x3FF, (v >> 10) & 0x3FF, (v >> 20) & 0x3FF]


def _deltas(packed: np.ndarray, w: int, p: int, base: int = 512):
    """The kernel's `deltas`: (cur - up) - (left - upleft), row 0 against
    base, column 0 without the left term."""
    r, x = divmod(p, w)
    cur = _channels(packed, p)
    up = _channels(packed, p - w) if r else [base] * 3
    if x:
        left = _channels(packed, p - 1)
        upleft = _channels(packed, p - w - 1) if r else [base] * 3
    return [(cur[c] - up[c]) - ((left[c] - upleft[c]) if x else 0)
            for c in range(3)]


def down_pack_model(packed: np.ndarray, bits: int,
                    cap: int = wk.DOWN_ESC) -> np.ndarray:
    """uhdr_down_pack's two launches over CTAs of TILE samples."""
    h, w = packed.shape[:2]
    n = h * w
    groups = -(-n // 32)
    sec = groups * bits + 2 * cap
    wire_ = np.zeros(3 * sec + 3, np.uint32)
    half, lim = 1 << (bits - 1), 1 << bits
    n_blocks = -(-groups * 32 // TILE)
    counts = np.zeros((3, n_blocks), np.int64)
    deltas = {p: _deltas(packed, w, p) for p in range(n)}
    # (a) down_words
    for b in range(n_blocks):
        for step in range(TILE // THREADS):
            for warp in range(THREADS // 32):
                first = b * TILE + step * THREADS + warp * 32
                g = first // 32
                if g >= groups:
                    break
                for c in range(3):
                    codes = []
                    for lane in range(32):
                        p = first + lane
                        code = deltas[p][c] + half if p < n else half
                        esc = p < n and not 0 <= code < lim
                        counts[c, b] += esc
                        codes.append(half if esc else code)
                    for j in range(bits):
                        wire_[c * sec + g * bits + j] = sum(
                            ((codes[lane] >> j) & 1) << lane
                            for lane in range(32))
    # (b) down_escapes
    for c in range(3):
        total = int(counts[c].sum())
        wire_[3 * sec + c] = total
        idx = wire_[c * sec + groups * bits:][:cap].view(np.int32)
        val = wire_[c * sec + groups * bits + cap:][:cap].view(np.int32)
        idx[total:] = n
        val[total:] = 0
        for b in range(n_blocks):
            pos = int(counts[c, :b].sum())
            if counts[c, b] == 0 or pos >= cap:
                continue
            for step in range(TILE // THREADS):
                for t in range(THREADS):
                    p = b * TILE + step * THREADS + t
                    if p < n and not 0 <= deltas[p][c] + half < lim:
                        if pos < cap:
                            idx[pos], val[pos] = p, deltas[p][c]
                        pos += 1
    return wire_


def _unslice_cases():
    rs = np.random.RandomState(18)
    out = []
    for bits in range(2, 9):
        for n in (1, 31, 32, 32 * 40 + 7):
            out.append((f"fixed{bits}-{n}", _words(rs, -(-n // 32) * bits), n,
                        bits, None))
    vws = [rs.randint(0, 16, 37), rs.randint(0, 16, 129),
           np.zeros(64, np.int64), np.full(64, 12), np.full(9, 15)]
    vws[0][:3] = (0, 12, 0)
    for k, wid in enumerate(vws):
        live = int(np.minimum(wid, 12).sum())
        pay = _words(rs, max(1, live // 2 if k == 1 else live))
        for n in (32 * wid.size, 32 * wid.size - 5):
            out.append((f"vw{k}-{n}", pay, n, 0, wid.astype(np.int32)))
    return out


@pytest.mark.parametrize("case", _unslice_cases(), ids=lambda c: c[0])
def test_unslice_model_equals_plain(case):
    _, payload, n, bits, widths = case
    pay = torch.from_numpy(payload)
    if widths is None:
        plain = wk.unslice_plain(pay, n, bits=bits)
    else:
        wt = torch.from_numpy(widths)
        plain = wk.unslice_plain(pay, n, widths=wt, offsets=torch.cumsum(
            wt, 0, dtype=torch.int32) - wt)
    np.testing.assert_array_equal(
        unslice_model(payload, n, bits, widths), plain.numpy())


def _down_input(fmt: str, h: int, w: int, noisy: bool, seed: int = 18):
    """Phase 18a's download inputs: smooth (or noisy) channels whose first
    and last samples jump far from their neighbours."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(300 + 2 * xx + yy + c * 50
              + (rs.randint(0, 400, (h, w)) if noisy else 0)) % 1024
             for c in range(3)]
    for ch in chans:
        ch[0, 0], ch[-1, -1] = 1023, 0
    if fmt == "1010102":
        return (chans[0] | chans[1] << 10 | chans[2] << 20
                | 3 << 30).astype(np.uint32).view(np.int32)
    return np.stack([0x3000 + 16 * c for c in chans]
                    + [np.full((h, w), 0x3C00)], -1).astype(
                        np.uint16).view(np.int16)


@pytest.mark.parametrize("fmt", ["1010102", "f16"])
@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("shape,noisy,cap", [((7, 9), False, wk.DOWN_ESC),
                                             ((4, 16), False, wk.DOWN_ESC),
                                             ((9, 7), True, 5)],
                         ids=["ragged", "aligned", "over-cap"])
def test_down_pack_model_equals_plain(fmt, bits, shape, noisy, cap):
    packed = _down_input(fmt, *shape, noisy)
    plain = wk.down_pack_plain(torch.from_numpy(packed), bits=bits, cap=cap)
    model = down_pack_model(packed, bits, cap)
    np.testing.assert_array_equal(model, plain.numpy().view(np.uint32))
    counts = model[-3:]
    n = shape[0] * shape[1]
    nw = -(-n // 32) * bits
    if noisy:
        assert (counts > cap).any()
    else:
        assert model[nw] == 0 and model[nw + counts[0] - 1] == n - 1


def test_down_pack_model_across_ctas():
    """An output of 10,000 samples spans two CTAs of 8,192: the second's
    escapes land after the first's, and the capped list keeps the first
    cap in sample order."""
    packed = _down_input("1010102", 100, 100, True, seed=4)
    for cap in (wk.DOWN_ESC, 7000):
        plain = wk.down_pack_plain(torch.from_numpy(packed), bits=4, cap=cap)
        np.testing.assert_array_equal(down_pack_model(packed, 4, cap),
                                      plain.numpy().view(np.uint32))


def test_dispatch_never_falls_back(monkeypatch):
    """A CPU tensor takes the plain version and counts no launch; the
    wrappers refuse CPU tensors; another device raises; a CUDA request
    without a GPU raises; a kernel that does not build raises before
    anything else runs."""
    pay = torch.arange(40, dtype=torch.int32)
    packed = torch.from_numpy(_down_input("1010102", 5, 8, False))
    before = (wk.UNSLICE_KERNEL.launches, wk.DOWN_PACK_KERNEL.launches)
    assert torch.equal(wk.unslice(pay, 64, bits=5),
                       wk.unslice_plain(pay, 64, bits=5))
    assert torch.equal(wk.down_pack(packed, bits=4),
                       wk.down_pack_plain(packed, bits=4))
    with pytest.raises(ValueError):
        wk.UNSLICE_KERNEL(pay, 64, bits=5)
    with pytest.raises(ValueError):
        wk.DOWN_PACK_KERNEL(packed, bits=4)
    with pytest.raises(port.UhdrError):
        wk.unslice(pay.to("meta"), 64, bits=5)
    with pytest.raises(port.UhdrError):
        wk.down_pack(packed.to("meta"), bits=4)
    img = testing.photo_p010(64, 32)
    monkeypatch.setenv("UHDR_TPU_WIRE", "vw")
    with pytest.raises((RuntimeError, AssertionError)):
        fused.upload_p010(img, torch.device("cuda"))
    blob = wire.pack_coeff_blob([np.zeros((2, 2, 64), np.int16)])
    with pytest.raises((RuntimeError, AssertionError)):
        wire.upload_coeff_blob(blob, torch.device("cuda"))

    # a CUDA tensor's stand-in: the wrapper builds before it allocates, so a
    # build that fails raises there, and the plain version never runs
    monkeypatch.setattr(_buildlib, "nvcc", lambda: "/nonexistent/nvcc")
    monkeypatch.setattr(wk.WIRE_LIB, "_lib", None)
    monkeypatch.setattr(wk, "unslice_plain", None)
    monkeypatch.setattr(wk, "down_pack_plain", None)
    cuda = torch.device("cuda", 0)

    def fake(shape, dtype, dim=1):
        return types.SimpleNamespace(
            device=cuda, dtype=dtype, shape=shape, dim=lambda: dim,
            is_contiguous=lambda: True, numel=lambda: int(np.prod(shape)),
            data_ptr=lambda: 0)
    with pytest.raises(OSError):
        wk.unslice(fake((40,), torch.int32), 64, bits=5)
    with pytest.raises(OSError):
        wk.down_pack(fake((5, 8), torch.int32, 2), bits=4)
    assert (wk.UNSLICE_KERNEL.launches, wk.DOWN_PACK_KERNEL.launches) \
        == before
