"""The wire kernels' contract, on the CPU.

``csrc/wire_kernel.cu`` holds two kernels that run only on the card, where
``chip_smoke.py`` phase 18 holds them against their plain versions bit for
bit.  Here:

- numpy models of both, written from the source.  ``uhdr_wire_unslice``:
  CTA runs of 256 groups, each run's offsets clamped to [-16, n_payload]
  and its word span [lo, hi] staged (a 16-byte aligned middle whose shift
  follows the payload's alignment, a few words at each end, the words
  outside the payload holding the clamped word) or, when the span exceeds
  the CTA's room, read with the index clamp; eight threads a group, four
  samples each, the bias by width, 16-byte stores where the four fit.
  ``uhdr_down_pack``: tiles of 8,192 samples, each staged
  with the w + 1 samples before it (or, past the halo's room, the row above
  read from device memory); steps of 1,024 samples, a warp four groups, the
  column kept by adding 32 mod w; RGBA1010102's deltas in 12-bit fields;
  interior tiles without row-0 or liveness tests; each channel's four
  codes a lane packed into bytes, a 32 x 32 bit transpose of shuffle-xor
  rounds and one shuffle to the lanes' front; the escape masks by ballot
  and the tiles' counts (launch 1), their prefix sums (launch 2), each
  tile's share of the padding and its escapes below cap, ranked by a scan
  of its groups' mask counts and recomputed from the output (launch 3).  Each model equals the
  plain version on phase 18a's edge cases (fixed rungs of 2-8 bits, vw
  widths 0-15, sample counts no multiple of 32, a payload shorter than its
  offsets; both download formats at 3, 4, 6 and 8 bits, escapes at the
  first and last sample, counts above cap, outputs over several tiles) and
  on the seams of the new designs (``testing.unslice_edge_cases``,
  ``testing.down_pack_edge_cases``);
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

# csrc/wire_kernel.cu
THREADS, RUN, RUN_WORDS, VW_MAX = 256, 256, 16, 12
TILE, WORDS_THREADS = 8192, 512
STEP = WORDS_THREADS // 32 * 4 * 32
HALO_LIMIT = 200 * 1024
LANES = np.arange(32)


def _words(rs, n) -> np.ndarray:
    return rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)


def unslice_model(payload: np.ndarray, n: int, bits: int = 0, widths=None,
                  offsets=None, align: int = 0) -> np.ndarray:
    """uhdr_wire_unslice: CTA runs of RUN groups; `align` is the payload's
    word address mod 4."""
    p = payload.view(np.uint32).astype(np.int64)
    np_ = p.size
    groups = -(-n // 32) if widths is None else widths.size
    if widths is not None and offsets is None:
        offsets = np.cumsum(widths) - widths
    per_group = RUN_WORDS if widths is not None or bits < RUN_WORDS else bits
    room = RUN * per_group + 8
    out = np.full(n, -12345, np.int64)
    for g0 in range(0, groups, RUN):
        gs = np.arange(g0, min(g0 + RUN, groups))
        live = gs * 32 < n
        if widths is None:
            w = np.full(gs.size, bits)
            words = w.copy()
            o = gs * bits
        else:
            w = widths[gs].astype(np.int64)
            words = np.clip(w, 0, VW_MAX)
            o = offsets[gs].astype(np.int64)
        o = np.clip(o, -16, np_)
        words = np.where(live, words, 0)
        act = words > 0
        lo = int(o[act].min()) if act.any() else 2 ** 31 - 1
        hi = int((o + words - 1)[act].max()) if act.any() else -2 ** 31
        shift = (align + lo) & 3
        staged = hi >= lo and hi - lo + 1 + shift <= room
        if staged:
            span = np.full(hi - lo + 1 + shift, -1, np.int64)
            a, b = max(lo, 0), min(hi + 1, np_)
            av = bv = hi + 1
            if a < b:
                va, vb = a + ((4 - ((align + a) & 3)) & 3), b - ((align + b) & 3)
                if va < vb:
                    av, bv = va, vb
            assert av == bv or ((av - lo + shift) % 4 == 0
                                and (bv - av) % 4 == 0)
            span[av - lo + shift:bv - lo + shift] = p[av:bv]   # 16-byte units
            ends = list(range(lo, av)) + list(range(bv, hi + 1))
            assert len(ends) <= 32
            for idx in ends:
                span[idx - lo + shift] = p[min(max(idx, 0), np_ - 1)]
            assert (span[shift:] >= 0).all()
        for k, g in enumerate(gs):
            if not live[k]:
                continue
            if widths is None:
                bias = 1 << (bits - 1)
            else:
                bias = (1 << (int(w[k]) - 1)) if w[k] > 0 else 0
            for l0 in range(0, 32, 4):       # eight threads, four samples
                s = np.zeros(4, np.int64)
                for j in range(int(words[k])):
                    if staged:
                        word = span[int(o[k]) - lo + shift + j]
                    else:
                        word = p[min(max(int(o[k]) + j, 0), np_ - 1)]
                    s |= ((word >> (l0 + np.arange(4))) & 1) << j
                i = g * 32 + l0
                for q in range(4):
                    if i + q < n:
                        out[i + q] = s[q] - bias
    assert (out != -12345).all()
    return out.astype(np.uint32).view(np.int32) if out.size else \
        out.astype(np.int32)


def _transpose32(x: np.ndarray) -> np.ndarray:
    """transpose32: five rounds over 32 lanes' uint32 words, each lane
    sending its word rotated left by s (lane & s) or by 32 - s and keeping
    its low (lane & s clear) or high s-bit halves of each 2s-bit block."""
    x = x.astype(np.uint32)
    for s, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        m = np.uint32(m)
        high = (LANES & s) != 0
        keep = np.where(high, ~m, m).astype(np.uint32)
        r = np.where(high, s, 32 - s).astype(np.uint32)
        send = ((x << r) | (x >> ((np.uint32(32) - r) & np.uint32(31))))
        x = ((x & keep) | (send.astype(np.uint32)[LANES ^ s] & ~keep)) \
            .astype(np.uint32)
    return x


def _pixels(packed: np.ndarray) -> np.ndarray:
    """The output as the kernel's pixels: RGBA1010102 uint32 words, RGBAF16
    (x, y) uint32 pairs."""
    if packed.ndim == 3:
        return packed.reshape(-1, 4).view(np.uint32).reshape(-1, 2).astype(
            np.int64)
    return packed.reshape(-1).view(np.uint32).astype(np.int64)


def _deltas3(f16: bool, cur, up, left, ul):
    """deltas3: (cur - up) - (left - upleft) of the three channels."""
    if f16:
        ch = [lambda v: v[..., 0] & 0xFFFF, lambda v: v[..., 0] >> 16,
              lambda v: v[..., 1] & 0xFFFF]
        return [f(cur) + f(ul) - f(up) - f(left) for f in ch]
    ke, ko = 0x3FF003FF, 0x000FFC00
    de = ((cur & ke) + (ul & ke) + 0x80000800 - (up & ke) - (left & ke)) \
        & 0xFFFFFFFF
    dn = ((cur & ko) + (ul & ko) + (2048 << 10) - (up & ko) - (left & ko)) \
        & 0xFFFFFFFF
    return [(de & 0xFFF) - 2048, (dn >> 10) - 2048, (de >> 20) - 2048]


def down_pack_model(packed: np.ndarray, bits: int, cap: int = wk.DOWN_ESC,
                    base: int = 512, align: int = 0) -> np.ndarray:
    """uhdr_down_pack: tiles of TILE samples in claim order; `align` is the
    output's word address mod 4."""
    f16 = packed.ndim == 3
    h, w = packed.shape[:2]
    n = h * w
    groups = -(-n // 32)
    n_tiles = -(-n // TILE)
    sec = groups * bits + 2 * cap
    wire_ = np.full(3 * sec + 3, 0xDEADBEEF, np.uint32)
    px = _pixels(packed)
    epx = 2 if f16 else 1
    base_px = np.array([base | base << 16, base]) if f16 else \
        base | base << 10 | base << 20
    zero_px = np.zeros(2, np.int64) if f16 else 0
    half, lim = 1 << (bits - 1), 1 << bits
    halo = ((TILE + w + 1) * epx + 4) * 4 <= HALO_LIMIT
    src = ((LANES // bits) * 8 + LANES % bits) & 31
    step32, step_rest = 32 % w, (STEP - 128) % w
    all_masks = np.zeros((3, n_tiles, TILE // 32), np.uint32)

    def global_deltas(p):
        """deltas_at on the output in device memory."""
        x = p % w
        first_row = p < w
        up = base_px if first_row else px[p - w]
        left, ul = zero_px, zero_px
        if x != 0:
            left = px[p - 1]
            ul = base_px if first_row else px[p - w - 1]
        return _deltas3(f16, np.asarray(px[p]), np.asarray(up),
                        np.asarray(left), np.asarray(ul))
    for tile in range(n_tiles):
        p0 = tile * TILE
        e = min(p0 + TILE, n)
        s0 = max(0, p0 - w - 1) if halo else max(0, p0 - 1)
        w0, w1 = s0 * epx, e * epx
        shift = (align + w0) & 3
        av = w0 + ((4 - ((align + w0) & 3)) & 3)
        bv = w1 - ((align + w1) & 3)
        if av >= bv:
            av = bv = w1
        stage = np.full(w1 - w0 + shift + 4, -1, np.int64)
        flat = px.reshape(-1)
        step_of = np.full(stage.size, -1)
        for k in range(TILE // STEP):     # commit group k's words
            lo_w = w0 if k == 0 else (p0 + k * STEP) * epx
            hi_w = (p0 + (k + 1) * STEP) * epx
            for wi in range(w0, w1):
                unit = av <= wi < bv
                first = av + (wi - av) // 4 * 4 if unit else wi
                if lo_w <= first < hi_w:
                    stage[wi - w0 + shift] = flat[wi]
                    step_of[wi - w0 + shift] = k
        assert (stage[shift:shift + (w1 - w0)] >= 0).all()
        tile_px = stage[shift:shift + (w1 - w0)]
        if f16:
            tile_px = tile_px.reshape(-1, 2)
        done = -1                             # the last step waited for

        def pix(p, up_row):
            if up_row and not halo:
                return px[p]                  # the row above from memory
            i = p - s0
            assert 0 <= i < tile_px.shape[0]
            wi = i * epx + shift
            assert (step_of[wi:wi + epx] <= done).all()
            return tile_px[i]

        # every sample live and below row 0: left and upper-left loaded
        # unconditionally, column 0 taking upper-left as its left
        interior = p0 >= w + 1 and p0 + TILE <= n

        def deltas(p, x):
            if interior:
                left, ul = pix(p - 1, False), pix(p - w - 1, True)
                if x == 0:
                    left = ul
                return _deltas3(f16, np.asarray(pix(p, False)),
                                np.asarray(pix(p - w, True)),
                                np.asarray(left), np.asarray(ul))
            first_row = p < w
            cur = pix(p, False)
            up = base_px if first_row else pix(p - w, True)
            left, ul = zero_px, zero_px
            if x != 0:
                left = pix(p - 1, False)
                ul = base_px if first_row else pix(p - w - 1, True)
            return _deltas3(f16, np.asarray(cur), np.asarray(up),
                            np.asarray(left), np.asarray(ul))

        masks = np.zeros((3, TILE // 32), np.uint32)
        xs = [(p0 + 128 * warp + LANES) % w
              for warp in range(WORDS_THREADS // 32)]
        for k in range(TILE // STEP):
            done = k
            if p0 + k * STEP >= e:
                break
            for warp in range(WORDS_THREADS // 32):
                x = xs[warp]
                codes = np.zeros((3, 32), np.uint32)
                for s in range(4):
                    lg = k * (STEP // 32) + warp * 4 + s
                    pp = p0 + lg * 32 + LANES
                    assert (x == pp % w).all()
                    live = pp < e
                    d = np.zeros((3, 32), np.int64)
                    for lane in np.nonzero(live)[0]:
                        d[:, lane] = deltas(int(pp[lane]), int(x[lane]))
                    for c in range(3):
                        code = (d[c] + half) & 0xFFFFFFFF
                        esc = live & (code >= lim)
                        masks[c, lg] = np.sum(esc.astype(np.int64) << LANES)
                        codes[c] |= (np.where(live & ~esc, code, half)
                                     .astype(np.uint32) << np.uint32(8 * s))
                    x = x + step32
                    x = np.where(x >= w, x - w, x)
                x = x + step_rest
                xs[warp] = np.where(x >= w, x - w, x)
                gq = p0 // 32 + k * (STEP // 32) + warp * 4
                for c in range(3):
                    word = _transpose32(codes[c])[src]
                    for lane in range(4 * bits):
                        if gq * bits + lane < groups * bits:
                            wire_[c * sec + gq * bits + lane] = word[lane]
        # the groups' masks (0 past the output) and the tile's counts
        live_g = p0 + 32 * np.arange(TILE // 32) < e
        all_masks[:, tile] = np.where(live_g, masks, 0)
    counts = np.array([[sum(bin(int(m)).count("1") for m in all_masks[c, k])
                        for k in range(n_tiles)] for c in range(3)])
    # launch 2: each channel's exclusive prefix sums, the totals
    prefix = np.cumsum(counts, axis=1) - counts
    total = counts.sum(axis=1)
    wire_[3 * sec:] = total
    # launch 3: a CTA a tile: its share of the padding, its escapes below
    # cap, each delta recomputed from the output in device memory
    padded = np.zeros((3, cap), np.int64)
    ctas = n_tiles
    for cta in range(ctas):
        for c in range(3):
            base_i = c * sec + groups * bits
            for t in range(THREADS):
                for j in range(int(total[c]) + cta * THREADS + t, cap,
                               ctas * THREADS):
                    wire_[base_i + j] = n
                    wire_[base_i + cap + j] = 0
                    padded[c, j] += 1
    for tile in range(n_tiles):
        p0 = tile * TILE
        for c in range(3):
            base_i = c * sec + groups * bits
            if not (counts[c, tile] > 0 and prefix[c, tile] < cap):
                continue
            own = np.array([bin(int(m)).count("1")
                            for m in all_masks[c, tile]])
            excl = np.cumsum(own) - own
            for t in np.nonzero(own)[0]:
                pos = int(prefix[c, tile]) + int(excl[t])
                m = int(all_masks[c, tile, t])
                while m and pos < cap:
                    l = (m & -m).bit_length() - 1
                    m &= m - 1
                    p = p0 + 32 * int(t) + l
                    wire_[base_i + pos] = p
                    wire_[base_i + cap + pos] = np.uint32(
                        global_deltas(p)[c] & 0xFFFFFFFF)
                    pos += 1
    for c in range(3):
        assert (padded[c, int(total[c]):] == 1).all()
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


@pytest.mark.parametrize("case", testing.unslice_edge_cases(),
                         ids=lambda c: c[0])
def test_unslice_model_edges(case):
    """The seams of the CTA runs: a run that ends mid-span, the payload's
    alignment (the staged span's shift), the clamp at the payload's end,
    widths 0 and 12, offsets that are no prefix sum (the span read from
    device memory), fixed rungs past 12 and 16 bits."""
    _, payload, n, bits, widths, offsets, align = case
    pay = torch.from_numpy(payload)
    if widths is None:
        plain = wk.unslice_plain(pay, n, bits=bits)
    else:
        wt = torch.from_numpy(widths)
        ot = torch.cumsum(wt, 0, dtype=torch.int32) - wt if offsets is None \
            else torch.from_numpy(offsets)
        plain = wk.unslice_plain(pay, n, widths=wt, offsets=ot)
    np.testing.assert_array_equal(
        unslice_model(payload, n, bits, widths, offsets, align),
        plain.numpy())


def test_unslice_model_shapes_its_paths():
    """The edge cases reach both of the model's paths: the staged span and,
    for offsets that are no prefix sum, the span too long for the room."""
    cases = {c[0]: c for c in testing.unslice_edge_cases()}
    _, payload, n, _, widths, offsets, _ = cases[
        "vw offsets no prefix sum (read from device memory)"]
    o = np.clip(offsets, -16, payload.size)
    assert int((o + np.minimum(widths, 12)).max() - o.min()) > RUN * RUN_WORDS
    _, payload, n, _, widths, _, _ = cases["vw clamp at the payload's end"]
    assert int(widths.sum()) > payload.size


def test_transpose32_model():
    """The warp transpose: lane j ends with bit j of every lane's word,
    lane l's at bit l."""
    rs = np.random.RandomState(15)
    x = rs.randint(0, 2 ** 32, 32, dtype=np.int64).astype(np.uint32)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1   # [lane, bit]
    want = (bits.T.astype(np.int64) << np.arange(32)).sum(axis=1)
    np.testing.assert_array_equal(_transpose32(x), want.astype(np.uint32))


@pytest.mark.parametrize("case", testing.down_pack_edge_cases(),
                         ids=lambda c: c[0])
def test_down_pack_model_edges(case):
    """The seams of the tiles: 1x1, h 1, w 1, widths no multiple of 32 or
    of the tile, rows wider than a tile and wider than the halo's room,
    escapes on both sides of a tile boundary, cap reached inside the first
    and the second tile, a count far past cap, the output's alignment."""
    name, packed, bits, cap, align = case
    plain = wk.down_pack_plain(torch.from_numpy(packed), bits=bits, cap=cap)
    model = down_pack_model(packed, bits, cap, align=align)
    np.testing.assert_array_equal(model, plain.numpy().view(np.uint32))
    counts = model[-3:].astype(np.int64)
    n = packed.shape[0] * packed.shape[1]
    idx = model[-(-n // 32) * bits:][:cap].astype(np.int64)
    if name.startswith("cap in the middle"):
        # escapes cap - 1 and cap of channel 0 lie in the same tile
        full = wk.down_pack_plain(torch.from_numpy(packed), bits=bits, cap=n)
        every = full.numpy()[-(-n // 32) * bits:][:int(counts[0])]
        tile = 0 if "first" in name else 1
        assert every[cap - 1] // TILE == every[cap] // TILE == tile
    if name == "count far past cap":
        assert (counts > 100 * cap).all()
    if name == "escapes straddle a tile boundary":
        got = idx[:counts[0]]
        assert ((got >= TILE - 6) & (got < TILE)).any()
        assert ((got >= TILE) & (got < TILE + 6)).any()


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
