"""PyTorch port: the slot-input block pack and tile pack against the TPU
kernels.

The port's slot math (device_entropy.slot_symbols, pack_kernel.
slots_for_kernel) must equal the JAX ``_slot_symbols`` / ``_slots_for_kernel``
exactly, and the plain versions of the two kernels must compute what the
Pallas kernels compute (run here in interpret mode): ``pack_blocks_plain``
against ``pack_blocks_pallas`` on all 54 buffer rows and the bit lengths,
``pack_tiles_plain`` against ``pack_tiles_pallas(budget=16)`` on the bit
lengths and every tile's live prefix (the rest of a TPU tile is undefined),
an overflowing tile included.  Both routes' words, joined by the shared
native joiner, give the bytes of the v3 engine (``pack_scan_plain``).

Layouts: the three of tests/test_pack_kernel.py with its content, 4:2:0,
4:4:4 and 4:0:0 planes carrying the pack's edge cases
(testing.coefficient_planes), one of them spanning two tiles, and a dense
single tile that overflows budget 16.  Every case is padded to the same two
tiles for the TPU kernels, so each compiles once (about 5 s and 22 s on a
CPU); the JAX results are computed once per module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libultrahdr_tpu.jpeg import device_entropy as jax_de
from libultrahdr_tpu.jpeg import pack_kernel as jax_pk

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import device_entropy as port_de
from libultrahdr_tpu_torch.jpeg import native as port_native
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pk

from test_torch_jax_native import guard_jax_native

guard_jax_native()

S420 = ((2, 2), (1, 1), (1, 1))
S444 = ((1, 1), (1, 1), (1, 1))
S400 = ((1, 1),)
# name -> (sampling, mcus_w, mcus_h, content)
CASES = {
    "420_8x6": (S420, 8, 6, "sparse"),
    "400_16x16": (S400, 16, 16, "dense"),
    "444_5x7": (S444, 5, 7, "sparse"),
    "420_edges": (S420, 11, 6, "edges"),
    "444_edges_two_tiles": (S444, 25, 30, "edges"),
    "400_edges": (S400, 30, 20, "edges"),
    "400_overflow": (S400, 64, 32, "full"),
}
BUDGET = 16
_PAD_BLOCKS = 2 * port_pk._TILE


def _planes(name):
    """tests/test_pack_kernel.py's random content, the edge cases, or
    blocks whose 63 AC coefficients are all large (about 50 words each)."""
    sampling, mw, mh, content = CASES[name]
    layout = port_de.scan_layout(sampling, mw, mh)
    if content == "edges":
        return testing.coefficient_planes(layout, seed=mw * mh)
    rs = np.random.RandomState(mw)
    out = []
    for hs, vs in sampling:
        bh, bw = mh * vs, mw * hs
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-300, 300, (bh, bw))
        if content == "full":
            sign = np.where(rs.rand(bh, bw, 63) < 0.5, -1, 1)
            c[..., 1:] = sign * rs.randint(512, 1024, (bh, bw, 63))
        else:
            dense = content == "dense"
            n_ac = 40 if dense else 20
            nz = rs.rand(bh, bw, n_ac) < (0.6 if dense else 0.3)
            c[..., 1:1 + n_ac] = np.where(
                nz, rs.randint(-200, 200, (bh, bw, n_ac)), 0)
        out.append(c)
    return out


def _port_scan(name):
    sampling, mw, mh, _ = CASES[name]
    layout = port_de.scan_layout(sampling, mw, mh)
    return [torch.from_numpy(p) for p in _planes(name)], layout


@pytest.fixture(scope="module")
def jax_slots():
    """name -> (pays, lens) of the JAX _slots_for_kernel, numpy (jitted per
    layout: far quicker here than its eager ops).  Their first 65 slots are
    the JAX _slot_symbols, concatenated unchanged."""
    out = {}
    for name, (sampling, mw, mh, _) in CASES.items():
        layout = jax_de.scan_layout(sampling, mw, mh)
        slots = jax.jit(lambda p, lay=layout: jax_pk._slots_for_kernel(
            p, lay))([jnp.asarray(p) for p in _planes(name)])
        out[name] = tuple(np.asarray(a) for a in slots)
    return out


def _padded(slots):
    pays, lens = (jnp.asarray(a) for a in slots)
    pad = ((0, _PAD_BLOCKS - pays.shape[0]), (0, 0))
    return jnp.pad(pays, pad), jnp.pad(lens, pad)


@pytest.fixture(scope="module")
def jax_blocks(jax_slots):
    """name -> (bb_t (54, n), blen) of pack_blocks_pallas in interpret
    mode."""
    out = {}
    for name, (pays, lens) in jax_slots.items():
        n = pays.shape[0]
        bb_t, blen = jax_pk.pack_blocks_pallas(*_padded((pays, lens)),
                                               interpret=True)
        out[name] = np.asarray(bb_t)[:, :n], np.asarray(blen)[:n]
    return out


@pytest.fixture(scope="module")
def jax_tiles(jax_slots):
    """name -> (tiles, blen) of pack_tiles_pallas(budget=16) in interpret
    mode, the pad tile dropped."""
    out = {}
    for name, (pays, lens) in jax_slots.items():
        n = pays.shape[0]
        tiles, blen = jax_pk.pack_tiles_pallas(*_padded((pays, lens)),
                                               budget=BUDGET, interpret=True)
        n_tiles = -(-n // port_pk._TILE)
        out[name] = np.asarray(tiles)[:n_tiles], np.asarray(blen)[:n]
    return out


def _slots(name):
    return port_pk.slots_for_kernel(*_port_scan(name))


@pytest.mark.parametrize("name", CASES)
def test_slot_symbols_match_jax(name, jax_slots):
    planes, layout = _port_scan(name)
    pays, lens = port_de.slot_symbols(planes, layout)
    shape = (layout.mcus_h, layout.bpr, port_pk._SLOTS)
    want_pays, want_lens = (a.reshape(shape)[..., :65]
                            for a in jax_slots[name])
    np.testing.assert_array_equal(pays.numpy(), want_pays.astype(np.int64))
    np.testing.assert_array_equal(lens.numpy(), want_lens)


@pytest.mark.parametrize("name", CASES)
def test_slots_for_kernel_match_jax(name, jax_slots):
    pays, lens = _slots(name)
    want_pays, want_lens = jax_slots[name]
    assert pays.dtype == lens.dtype == torch.int32
    assert pays.is_contiguous() and lens.is_contiguous()
    np.testing.assert_array_equal(pays.numpy().view(np.uint32), want_pays)
    np.testing.assert_array_equal(lens.numpy(), want_lens)


@pytest.mark.parametrize("name", CASES)
def test_pack_blocks_plain_matches_pallas(name, jax_blocks):
    bb_t, blen = port_pk.pack_blocks_plain(*_slots(name))
    want_bb, want_blen = jax_blocks[name]
    np.testing.assert_array_equal(blen.numpy(), want_blen)
    assert blen.numpy().max() <= port_pk._CAP * 32
    assert bb_t.shape == (port_pk._CAP, blen.shape[0])
    np.testing.assert_array_equal(bb_t.numpy().view(np.uint32), want_bb)


@pytest.mark.parametrize("name", CASES)
def test_pack_tiles_plain_matches_pallas(name, jax_tiles):
    tiles, blen = port_pk.pack_tiles_plain(*_slots(name), BUDGET)
    want_tiles, want_blen = jax_tiles[name]
    np.testing.assert_array_equal(blen.numpy(), want_blen)
    live = port_pk.tile_live_words(blen).numpy()
    np.testing.assert_array_equal(
        live, np.asarray(jax_pk.tile_live_words(jnp.asarray(want_blen),
                                                want_blen.size)))
    assert tiles.shape == want_tiles.shape
    tiles = tiles.numpy().view(np.uint32)
    for t, n_live in enumerate(np.minimum(live, tiles.shape[1])):
        np.testing.assert_array_equal(tiles[t, :n_live],
                                      want_tiles[t, :n_live])
    overflow = name == "400_overflow"
    assert (live > port_pk._TILE * BUDGET).any() == overflow
    if overflow:
        with pytest.raises(port_de.PackOverflowError):
            port_pk.check_tile_budgets(blen.numpy(), BUDGET)
    else:
        port_pk.check_tile_budgets(blen.numpy(), BUDGET)


@pytest.mark.parametrize("name", ["420_8x6", "400_16x16", "444_5x7"])
def test_block_buffers_and_compaction_match_the_xla_tree(name):
    """block_buffers_kernel and compact_blocks_t against the JAX package's
    plain engine, _block_buffers and _compact_blocks (XLA), on
    tests/test_pack_kernel.py's layouts and its output budget."""
    planes, layout = _port_scan(name)
    bb_t, blen = port_pk.block_buffers_kernel(planes, layout)
    sampling, mw, mh, _ = CASES[name]
    jax_layout = jax_de.scan_layout(sampling, mw, mh)
    n = blen.shape[0]
    w_out = n * jax_de._default_budget(n)

    def xla(p):
        bb, bl = jax_de._block_buffers(p, jax_layout)
        return bb, bl, jax_de._compact_blocks(bb, bl, w_out)
    bb, want_blen, want_words = (np.asarray(a) for a in jax.jit(xla)(
        [jnp.asarray(p) for p in _planes(name)]))
    np.testing.assert_array_equal(blen.numpy(), want_blen)
    np.testing.assert_array_equal(bb_t.numpy().view(np.uint32), bb.T)
    need = port_de.total_words(want_blen)
    words = port_pk.compact_blocks_t(bb_t, blen, w_out)
    np.testing.assert_array_equal(words.numpy()[:need].view(np.uint32),
                                  want_words[:need])


def _joined(words, blen, layout):
    return port_native.join_blocks(words.numpy().view(np.uint32),
                                   blen.numpy().astype(np.uint16), layout.bpr)


@pytest.mark.parametrize("name", [n for n in CASES if n != "400_overflow"])
def test_routes_join_to_the_v3_bytes(name):
    """The v1 route (compact_blocks_t) and the v2 route (stitch_tiles)
    give the v3 engine's scan bytes; their block lengths carry the row
    pads, which the v3 engine leaves to the joiner."""
    planes, layout = _port_scan(name)
    v3_words, v3_blen = port_pk.pack_scan_plain(
        *port_de.stream_inputs(planes, layout))
    scan = _joined(v3_words, v3_blen, layout)
    for route in (testing.pack_scans_v1, testing.pack_scans_v2):
        words, blen = route([(planes, layout)])
        assert _joined(words, blen, layout) == scan
        rows = blen.numpy().reshape(layout.mcus_h, layout.bpr)
        rows_v3 = v3_blen.numpy().reshape(layout.mcus_h, layout.bpr)
        np.testing.assert_array_equal(rows[:, :-1], rows_v3[:, :-1])
        np.testing.assert_array_equal(rows[:, -1] - rows_v3[:, -1],
                                      (-rows_v3.sum(axis=1)) % 8)


def test_two_scans_in_one_launch():
    """Both routes take several scans in one launch, like the encode's
    pack: split on the host, each joined scan equals the v3 bytes."""
    scans = [_port_scan("420_edges"), _port_scan("444_5x7")]
    for route in (testing.pack_scans_v1, testing.pack_scans_v2):
        words, blen = route(scans)
        blen = blen.numpy().astype(np.uint16)
        n0 = scans[0][1].mcus_h * scans[0][1].bpr
        joined = port_fused.fetch_blocks_multi(
            words.numpy().view(np.uint32),
            [(blen[:n0], scans[0][1].bpr), (blen[n0:], scans[1][1].bpr)])
        for got, (planes, layout) in zip(joined, scans):
            assert got == _joined(*port_pk.pack_scan_plain(
                *port_de.stream_inputs(planes, layout)), layout)


def test_v2_route_raises_on_overflow():
    with pytest.raises(port_de.PackOverflowError):
        testing.pack_scans_v2([_port_scan("400_overflow")], BUDGET)


def test_tile_budget_check():
    """tests/test_pack_kernel.py's case, on the port's check."""
    port_pk.check_tile_budgets(np.full(3000, 40, np.int32), budget=16)
    with pytest.raises(port_de.PackOverflowError):
        port_pk.check_tile_budgets(
            np.full(port_pk._TILE, 54 * 32, np.int32), budget=16)


def test_compact_and_stitch():
    """compact_blocks_t drops words past w_out and zero-fills after the
    live ones; stitch_tiles chains the live prefixes of every part."""
    pays, lens = _slots("420_8x6")
    bb_t, blen = port_pk.pack_blocks_plain(pays, lens)
    total = port_de.total_words(blen.numpy())
    full = port_pk.compact_blocks_t(bb_t, blen, total + 5)
    assert not full[total:].any()
    np.testing.assert_array_equal(
        port_pk.compact_blocks_t(bb_t, blen, total - 3), full[:total - 3])
    tiles = torch.arange(12, dtype=torch.int32).view(3, 4)
    np.testing.assert_array_equal(
        port_pk.stitch_tiles([(tiles, torch.tensor([2, 0, 4])),
                              (tiles[:1], torch.tensor([3]))]).numpy(),
        [0, 1, 8, 9, 10, 11, 0, 1, 2])


def test_block_pack_dispatch_never_falls_back():
    """CPU tensors take the plain versions; the kernel wrappers refuse CPU
    tensors without counting, and a device without an implementation
    raises."""
    pays, lens = _slots("444_5x7")
    bb_t, blen = port_pk.pack_blocks(pays, lens)
    np.testing.assert_array_equal(
        bb_t.numpy(), port_pk.pack_blocks_plain(pays, lens)[0].numpy())
    tiles, _ = port_pk.pack_tiles(pays, lens, BUDGET)
    assert tiles.shape == (1, port_pk._TILE * BUDGET)
    for kern, args in ((port_pk.PACK_BLOCKS_KERNEL, ()),
                       (port_pk.PACK_TILES_KERNEL, (BUDGET,))):
        before = kern.launches
        with pytest.raises(ValueError):
            kern(pays, lens, *args)
        assert kern.launches == before
    meta = (pays.to("meta"), lens.to("meta"))
    with pytest.raises(port.UhdrError):
        port_pk.pack_blocks(*meta)
    with pytest.raises(port.UhdrError):
        port_pk.pack_tiles(*meta, BUDGET)


def test_tile_pack_drops_only_the_overflowing_tiles_tail():
    """Three tiles of testing.synthetic_slots in which only the middle one
    overflows budget 16, its overflow beginning past its first 256 blocks
    (in a later sub-tile of the CUDA kernel's split): pack_tiles_plain's
    first and last tiles equal the compaction of pack_blocks_plain's
    buffers (compact_blocks_t per tile), and the middle tile keeps exactly
    its words below the budget."""
    tile, tile_words = port_pk._TILE, port_pk._TILE * BUDGET
    pays, lens = testing.synthetic_slots(3 * tile, seed=5,
                                         dense=[(tile + 640, 2 * tile)])
    lens64 = lens.to(torch.int64)
    assert ((pays.to(torch.int64) & 0xFFFFFFFF) < (1 << lens64)).all()
    tiles, blen = port_pk.pack_tiles_plain(pays, lens, BUDGET)
    bb_t, blen_b = port_pk.pack_blocks_plain(pays, lens)
    np.testing.assert_array_equal(blen.numpy(), blen_b.numpy())
    np.testing.assert_array_equal(blen.numpy(), lens64.sum(dim=1).numpy())
    assert int(blen.max()) <= port_pk._CAP * 32
    live = port_pk.tile_live_words(blen).numpy()
    assert live[0] <= tile_words < live[1] and live[2] <= tile_words
    wlen = (blen.numpy()[tile:2 * tile].astype(np.int64) + 31) >> 5
    assert np.argmax(np.cumsum(wlen) > tile_words) >= 256
    with pytest.raises(port_de.PackOverflowError):
        port_pk.check_tile_budgets(blen.numpy(), BUDGET)
    for t in range(3):
        part = slice(t * tile, (t + 1) * tile)
        want = port_pk.compact_blocks_t(bb_t[:, part], blen[part], tile_words)
        keep = min(int(live[t]), tile_words)
        np.testing.assert_array_equal(tiles[t, :keep].numpy(),
                                      want[:keep].numpy())
