"""The scan kernel's contract, on the CPU.

``csrc/dct_kernel.cu`` builds a whole scan's pack inputs (stream, DC
differences, luma flags) from its unpadded source planes; it runs only on
the card, where ``chip_smoke.py`` holds it against ``dct.scan_inputs_plain``
bit for bit.  Here:

- a numpy model of the kernel, written from its source: the grid of
  31-MCU strips and 32 groups of 8 threads (group 0 the MCU left of the
  strip, computing DCs only), each thread's clamped column loads, the
  RGB -> YCbCr conversion in its operation order, the exact byte and
  rounding tricks (2^23 + byte, 1.5 x 2^23), both passes with the
  swizzled shared-memory transpose, the division and the zigzag store at
  the stream index, and the DC predecessor read from the left group's
  shared DCs; it equals the plain composition bit for bit on 4:2:0,
  4:4:4 and RGB 4:4:4 and 4:0:0 layouts at chip_smoke phase 3's MCU grids
  and on an unaligned 960x540 map, with two quality tables;
- the plain scan builder against the JAX package's ``fused._scan_coeffs``
  and ``pack_kernel._stream_inputs``: coefficients within the JAX tie
  contract, the stream glue exact;
- row shards of a scan (whole MCU rows) give the whole scan's inputs;
- the dispatcher never falls back: CPU planes take the plain version, the
  kernel wrapper refuses them and counts nothing, another device raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu.jpeg import device_entropy as jax_de
from libultrahdr_tpu.jpeg import pack_kernel as jax_pk

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused
from libultrahdr_tpu_torch.jpeg import dct
from libultrahdr_tpu_torch.jpeg.tables import (STD_CHROMA_QUANT,
                                               STD_LUMA_QUANT, ZIGZAG_ORDER,
                                               scaled_quant_table)

from test_torch_jax_native import guard_jax_native

guard_jax_native()

F32 = np.float32
GROUPS, STRIP, T_ROW = 32, 31, 72


def _byte_value(b, shift):
    """__int_as_float(0x4B000000 | b) - (2^23 + shift): b - shift, exact."""
    return (np.asarray(b, np.uint32) | np.uint32(0x4B000000)).view(F32) \
        - F32(8388608 + shift)


def _round_even(v):
    return (v + F32(12582912.0)) - F32(12582912.0)


def _round_to_int(v):
    return ((v + F32(12582912.0)).view(np.int32) - np.int32(0x4B400000))


def _ycc_level_shifted(c, r, g, b):
    if c == 0:
        v = (F32(0.299) * r + F32(0.587) * g) + F32(0.114) * b
    elif c == 1:
        v = ((F32(-0.168735892) * r - F32(0.331264108) * g)
             + F32(0.5) * b) + F32(128.0)
    else:
        v = ((F32(0.5) * r - F32(0.418687589) * g)
             - F32(0.081312411) * b) + F32(128.0)
    return np.minimum(np.maximum(_round_even(v), F32(0)), F32(255)) \
        - F32(128.0)


def kernel_model(src: dct.ScanPlanes, layout):
    """(stream, dc_diff, is_luma) as the kernel computes them, every
    (strip, MCU row, group, lane) at once; the parameters are the ones the
    wrapper hands the kernel."""
    q = np.stack([np.asarray(t, F32).reshape(64) for t in src.qtables])
    p = dct._ScanParams.from_buffer_copy(dct._scan_params(
        tuple(layout.sampling), layout.mcus_w, layout.mcus_h, q.tobytes()))
    d = np.ctypeslib.as_array(p.d).reshape(8, 8)
    pos = np.ctypeslib.as_array(p.pos)
    bpm = p.bpm
    planes = [pl.numpy() for pl in src.planes]
    mh, mw = layout.mcus_h, layout.mcus_w
    # grid (strip x, MCU row m), group g, lane
    x, m, g = np.meshgrid(np.arange(-(-mw // STRIP)), np.arange(mh),
                          np.arange(GROUPS), indexing="ij")
    j = x * STRIP + g - 1
    live = (j >= 0) & (j < mw)
    writes = live & (g > 0)
    first = m.astype(np.int64) * layout.bpr + j.astype(np.int64) * bpm
    lane = np.arange(8)
    k = np.arange(8)
    stream = np.zeros((mh * layout.bpr, 64), np.int16)
    written = np.zeros(mh * layout.bpr, np.int64)
    dcs = np.zeros(j.shape + (bpm,), np.int32)

    def column(plane, y0, x0):
        """(..., lane, k) source bytes of column `lane`, rows y0 + k."""
        ph, pw = plane.shape
        rows = np.minimum(y0[..., None, None] + k, ph - 1)
        cols = np.minimum(x0[..., None, None] + lane[:, None], pw - 1)
        return plane[np.broadcast_arrays(rows, cols)]

    jj = np.maximum(j, 0)            # a dead group loads nothing: any MCU
    if src.rgb:
        rgb = [_byte_value(column(pl, m * 8, jj * 8), 0) for pl in planes]
    b = 0
    for c, (hs, vs) in enumerate(layout.sampling):
        for v in range(vs):
            for h in range(hs):
                if src.rgb:
                    xs = _ycc_level_shifted(c, *rgb)
                else:
                    xs = _byte_value(column(planes[c], (m * vs + v) * 8,
                                            (jj * hs + h) * 8), 128)
                # column pass, thread `lane` (column): t[u] in index order
                t = np.zeros(xs.shape, F32)             # (..., lane, u)
                for u in range(8):
                    acc = d[u, 0] * xs[..., 0]
                    for kk in range(1, 8):
                        acc = acc + d[u, kk] * xs[..., kk]
                    t[..., u] = acc
                # the group's buffer: row u, half-rows swapped on rows 4-7
                tb = np.zeros(xs.shape[:-2] + (T_ROW,), F32)
                for u in range(8):
                    at = u * 8 + ((((lane >> 2) ^ (u >> 2)) & 1) << 2) \
                        + (lane & 3)
                    tb[..., at] = t[..., :, u]
                swap = (lane >> 2) & 1
                lo = lane[:, None] * 8 + (swap[:, None] << 2) + np.arange(4)
                hi = lane[:, None] * 8 + ((swap[:, None] ^ 1) << 2) \
                    + np.arange(4)
                rows = np.concatenate([tb[..., lo], tb[..., hi]], axis=-1)
                # row pass, thread `lane` (row u): y[u][v], quantised
                ob = np.zeros(xs.shape[:-2] + (64,), np.int16)
                for v2 in range(8):
                    acc = rows[..., 0] * d[v2, 0]
                    for kk in range(1, 8):
                        acc = acc + rows[..., kk] * d[v2, kk]
                    qv = _round_to_int(acc / q[c][lane * 8 + v2])
                    ob[..., pos[lane * 8 + v2]] = qv
                    if v2 == 0:
                        dcs[..., b] = qv[..., 0]
                at = first[writes] + b
                stream[at] = ob[writes]
                written[at] += 1
                b += 1
    assert (written == 1).all()            # every block once
    # after the barrier: each block's DC less its predecessor's
    comp = np.ctypeslib.as_array(p.comp_of)[:bpm]
    prev = np.ctypeslib.as_array(p.prev_of)[:bpm]
    is_first = np.ctypeslib.as_array(p.first_of)[:bpm].astype(bool)
    left = np.concatenate([np.zeros_like(dcs[:, :, :1]), dcs[:, :, :-1]],
                          axis=2)
    before = np.where(is_first, left[..., prev], dcs[..., prev])
    before = np.where(is_first & (j[..., None] == 0), 0, before)
    dc_diff = np.zeros(mh * layout.bpr, np.int32)
    is_luma = np.zeros(mh * layout.bpr, np.int32)
    at = first[writes][:, None] + np.arange(bpm)
    dc_diff[at] = (dcs - before)[writes]
    is_luma[at] = np.broadcast_to(comp == 0, at.shape)
    return stream, dc_diff, is_luma


def _planes(shapes, seed):
    rs = np.random.RandomState(seed)
    out = []
    for s in shapes:
        smooth = np.add.outer(np.arange(s[0]) * 3, np.arange(s[1]) * 2)
        out.append(np.clip(smooth % 256 + rs.randint(-60, 61, s), 0,
                           255).astype(np.uint8))
    return [torch.from_numpy(p) for p in out]


def _tables(quality):
    return [scaled_quant_table(STD_LUMA_QUANT, quality),
            scaled_quant_table(STD_CHROMA_QUANT, quality),
            scaled_quant_table(STD_CHROMA_QUANT, quality)]


def _scan(kind, w, h, quality, seed=0):
    """A scan of `kind` whose planes come out at w x h pixels (4:2:0
    chroma at half size, rounded up, as the encodes hand it over)."""
    q = _tables(quality)
    if kind == "420":
        cw, ch = -(-w // 2), -(-h // 2)
        return fused._scan(_planes([(h, w), (ch, cw), (ch, cw)], seed),
                           fused._SAMPLING_420, q)
    if kind == "400":
        return fused._scan(_planes([(h, w)], seed), fused._SAMPLING_400,
                           q[:1])
    return fused._scan(_planes([(h, w)] * 3, seed), fused._SAMPLING_444, q,
                       rgb=kind == "rgb")


# chip_smoke phase 3's MCU grids (24x16 4:2:0, 37x21 4:4:4, 61x45 4:0:0)
# as image sizes, every sampling on each, two short of whole MCUs on the
# last; an unaligned 4K-like gain map (960x540, 68 MCU rows of 8 where the
# last has 4)
SIZES = [(24 * 16, 16 * 16), (37 * 8, 21 * 8), (61 * 8 - 2, 45 * 8 - 2),
         (960, 540)]


@pytest.mark.parametrize("kind", ["420", "444", "rgb", "400"])
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("quality", [95, 60])
def test_kernel_model_equals_plain(kind, w, h, quality):
    src, layout = _scan(kind, w, h, quality, seed=w + quality)
    got = kernel_model(src, layout)
    want = dct.scan_inputs_plain([(src, layout)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def _exact_ratio(plane_u8, q):
    k = np.arange(8)
    dm = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    dm[0, :] = np.sqrt(1.0 / 8.0)
    h, w = plane_u8.shape
    x = plane_u8.astype(np.float64) - 128.0
    b = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    ratio = (dm @ b @ dm.T) / np.asarray(q, np.float64).reshape(8, 8)
    return ratio.reshape(h // 8, w // 8, 64)[..., ZIGZAG_ORDER]


@pytest.mark.parametrize("kind", ["420", "rgb", "400"])
def test_plain_scan_against_jax(kind):
    """Coefficients within the JAX tie contract (they differ only where the
    exact quotient lies within 1e-3 of a half, by at most 1); the JAX glue
    on the port's coefficients gives the port's stream inputs exactly.
    An RGB scan's YCbCr planes are the port's (``rgb_to_ycbcr`` against
    JAX's: ``test_pad_edge_and_rgb_to_ycbcr_match_jax``)."""
    src, layout = _scan(kind, 130, 66, 95, seed=7)
    planes = dct.rgb_to_ycbcr(src.planes) if src.rgb else src.planes
    ours = dct.scan_coeffs_plain(src, layout)
    theirs, jlayout = jax_fused._scan_coeffs(
        [jnp.asarray(p.numpy()) for p in planes], layout.sampling,
        src.qtables)
    assert (jlayout.mcus_w, jlayout.mcus_h, jlayout.bpr) == \
        (layout.mcus_w, layout.mcus_h, layout.bpr)
    for a, b, p, qt in zip(ours, theirs, planes, src.qtables):
        a, b = a.numpy(), np.asarray(b)
        padded = dct.pad_edge(p, a.shape[0] * 8, a.shape[1] * 8).numpy()
        ratio = _exact_ratio(padded, qt)
        near_tie = np.abs(np.abs(ratio - np.round(ratio)) - 0.5) < 1e-3
        assert not ((a != b) & ~near_tie).any()
        assert np.abs(a.astype(np.int32) - b).max() <= 1
    stream, dcd, lum = jax_pk._stream_inputs(
        [jnp.asarray(c.numpy()) for c in ours],
        jax_de.scan_layout(layout.sampling, layout.mcus_w, layout.mcus_h))
    for a, b in zip(dct.scan_inputs_plain([(src, layout)]),
                    (stream, dcd, lum)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind,rows", [("420", 32), ("rgb", 16),
                                       ("400", 24)])
def test_row_shards_equal_the_whole_scan(kind, rows):
    """Shards of whole MCU rows (as parallel/ cuts an image) build the
    whole scan's blocks and DC differences: every MCU row restarts."""
    src, layout = _scan(kind, 136, 96, 90, seed=3)
    whole = dct.scan_inputs_plain([(src, layout)])
    parts = []
    for r0 in range(0, 96, rows):
        sub = [p[r0 * p.shape[0] // 96:(r0 + rows) * p.shape[0] // 96]
               for p in src.planes]
        parts.append(fused._scan(sub, layout.sampling, src.qtables,
                                 rgb=src.rgb))
    split = dct.scan_inputs_plain(parts)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


def test_scans_back_to_back_and_the_plane_form():
    """Two scans' inputs concatenate in order; a plane's coefficients are
    a one-component scan in raster order (``forward_plane``)."""
    base, gm = _scan("420", 40, 24, 95, 1), _scan("rgb", 40, 24, 80, 2)
    both = dct.scan_inputs([base, gm])
    for a, b, c in zip(both, dct.scan_inputs([base]), dct.scan_inputs([gm])):
        assert torch.equal(a, torch.cat([b, c]))
    plane = _planes([(20, 36)], 5)[0]
    q = scaled_quant_table(STD_LUMA_QUANT, 95)
    coeffs = dct.forward_plane(dct.pad_edge(plane, 24, 40), q)
    layout = fused._layout_for(20, 36, fused._SAMPLING_400)
    stream = dct.scan_inputs([(dct.ScanPlanes([plane], [q]), layout)])[0]
    assert torch.equal(stream.reshape(3, 5, 64), coeffs)


def test_scan_dispatch_never_falls_back():
    src, layout = _scan("420", 32, 16, 95)
    n = layout.mcus_h * layout.bpr
    before = dct.FORWARD_DCT_KERNEL.launches
    with pytest.raises(ValueError):
        dct.FORWARD_DCT_KERNEL.scan(src, layout,
                                    torch.empty((n, 64), dtype=torch.int16))
    assert dct.FORWARD_DCT_KERNEL.launches == before
    meta = dct.ScanPlanes([p.to("meta") for p in src.planes], src.qtables)
    with pytest.raises(port.UhdrError):
        dct.scan_inputs([(meta, layout)])
    assert all(torch.equal(a, b) for a, b in zip(
        dct.scan_inputs([(src, layout)]),
        dct.scan_inputs_plain([(src, layout)])))


def test_pack_scans_takes_both_forms():
    """``fused._pack_scans`` builds ScanPlanes scans with ``scan_inputs``
    and takes coefficient planes through the stream glue, to the same
    words."""
    from libultrahdr_tpu_torch.jpeg import pack_kernel
    scans = [_scan("420", 48, 32, 95, 4), _scan("400", 24, 16, 95, 5)]
    coeff_scans = [(dct.scan_coeffs_plain(s, lay), lay) for s, lay in scans]
    got = fused._pack_scans(scans, pack_kernel.pack_scan)
    want = fused._pack_scans(coeff_scans, pack_kernel.pack_scan)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
