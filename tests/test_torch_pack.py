"""PyTorch port: the Huffman pack's plain version against the TPU kernel.

pack_kernel.pack_scan_plain must compute exactly what the Pallas kernel
_pack_tiles_v3 computes (run here in interpret mode, then stitched with
stitch_tiles): bit-identical block lengths (no restart-row pad) and live
words, and so byte-identical joined scans, which the shared native decoder
turns back into the input coefficients.  Layouts: the three of
tests/test_pack_kernel.py with its content, and 4:2:0, 4:4:4 and 4:0:0
planes carrying the pack's edge cases (testing.coefficient_planes), one of
them spanning two kernel tiles.  Every case is padded to the same two tiles
for the TPU kernel, so interpret mode compiles once."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu.jpeg import device_entropy as jax_de
from libultrahdr_tpu.jpeg import pack_kernel as jax_pk

from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import device_entropy as port_de
from libultrahdr_tpu_torch.jpeg import native as port_native
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pk
from libultrahdr_tpu_torch.jpeg.tables import (AC_CHROMA, AC_LUMA, DC_CHROMA,
                                               DC_LUMA)

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
}
_PAD_BLOCKS = 2 * jax_pk._TILE


def _planes(name):
    """tests/test_pack_kernel.py's random content, or the edge cases."""
    sampling, mw, mh, content = CASES[name]
    layout = port_de.scan_layout(sampling, mw, mh)
    if content == "edges":
        return testing.coefficient_planes(layout, seed=mw * mh)
    dense = content == "dense"
    rs = np.random.RandomState(mw)
    out = []
    for hs, vs in sampling:
        bh, bw = mh * vs, mw * hs
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-300, 300, (bh, bw))
        n_ac = 40 if dense else 20
        nz = rs.rand(bh, bw, n_ac) < (0.6 if dense else 0.3)
        c[..., 1:1 + n_ac] = np.where(
            nz, rs.randint(-200, 200, (bh, bw, n_ac)), 0)
        out.append(c)
    return out


@functools.lru_cache(maxsize=None)
def _jax_v3(name):
    """(stream, dc_diff, is_luma, words, blen) of the TPU kernel in
    interpret mode; the stream is padded to two tiles so every case shares
    one compile, and the pad blocks sit after the live words."""
    sampling, mw, mh, _ = CASES[name]
    layout = jax_de.scan_layout(sampling, mw, mh)
    stream, dcd, lum = jax_pk._stream_inputs(
        [jnp.asarray(p) for p in _planes(name)], layout)
    n = stream.shape[0]
    assert n <= _PAD_BLOCKS
    pad = _PAD_BLOCKS - n
    tiles, blen = jax_pk._pack_tiles_v3(
        jnp.pad(stream, ((0, pad), (0, 0))), jnp.pad(dcd, (0, pad)),
        jnp.asarray(np.pad(lum, (0, pad))), budget=jax_de._BLOCK_CAP_WORDS,
        interpret=True)
    live = jax_pk.tile_live_words(blen, _PAD_BLOCKS)
    words = np.asarray(jax_pk.stitch_tiles([(tiles, live)]))
    blen = np.asarray(blen)[:n]
    need = jax_de.total_words_v2(blen)
    return (np.asarray(stream), np.asarray(dcd), np.asarray(lum),
            words[:need], blen)


@functools.lru_cache(maxsize=None)
def _port(name):
    """(layout, stream inputs, words u32, blen) of the port's plain pack."""
    sampling, mw, mh, _ = CASES[name]
    layout = port_de.scan_layout(sampling, mw, mh)
    ins = port_de.stream_inputs([torch.from_numpy(p) for p in _planes(name)],
                                layout)
    words, blen = port_pk.pack_scan_plain(*ins)
    return layout, ins, words.numpy().view(np.uint32), blen.numpy()


@pytest.mark.parametrize("name", CASES)
def test_stream_inputs_match_jax(name):
    stream, dcd, lum, _, _ = _jax_v3(name)
    _, (s, d, lu), _, _ = _port(name)
    np.testing.assert_array_equal(s.numpy(), stream)
    np.testing.assert_array_equal(d.numpy(), dcd)
    np.testing.assert_array_equal(lu.numpy(), lum)


@pytest.mark.parametrize("name", CASES)
def test_plain_pack_bit_identical_to_v3(name):
    _, _, _, words_ref, blen_ref = _jax_v3(name)
    _, _, words, blen = _port(name)
    np.testing.assert_array_equal(blen, blen_ref)
    assert blen.max() <= 1680                  # fits the joiner's u16
    np.testing.assert_array_equal(words, words_ref)


@pytest.mark.parametrize("name", CASES)
def test_joined_scan_identical_and_decodes(name):
    """The joined scans are byte-identical, and decoding the port's scan
    gives back the input coefficients."""
    _, _, _, words_ref, blen_ref = _jax_v3(name)
    layout, _, words, blen = _port(name)
    scan_ref = port_native.join_blocks(words_ref, blen_ref.astype(np.uint16),
                                       layout.bpr)
    scan = port_native.join_blocks(words, blen.astype(np.uint16), layout.bpr)
    assert scan == scan_ref
    comps = [{"h": hs, "v": vs, "dc_tbl": int(i > 0), "ac_tbl": int(i > 0)}
             for i, (hs, vs) in enumerate(layout.sampling)]
    got, _ = port_native.decode_scan(
        scan + b"\xFF\xD9", comps, layout.mcus_w, layout.mcus_h,
        [DC_LUMA, DC_CHROMA, None, None], [AC_LUMA, AC_CHROMA, None, None],
        restart_interval=layout.mcus_w)
    for g, p in zip(got, _planes(name)):
        np.testing.assert_array_equal(g, p)


def test_edge_cases_present():
    """The edge-case planes really hold what they are for: blocks without
    EOB, ZRL runs, |AC| 1023 and |DC diff| 2047."""
    for name in ("420_edges", "444_edges_two_tiles", "400_edges"):
        _, (s, d, _), _, blen = _port(name)
        s = s.numpy()
        assert (s[:, 63] != 0).any() and (s[:, 1:] == 0).all(axis=1).any()
        assert np.abs(s[:, 1:]).max() == 1023
        assert np.abs(d.numpy()).max() == 2047
    assert _port("444_edges_two_tiles")[3].size > jax_pk._TILE


def test_two_scans_in_one_launch():
    """The encode packs the base and gain-map scans in one call on their
    concatenated streams; split on the host, each joined scan equals the
    scan packed alone."""
    base, gm = _port("420_edges"), _port("444_5x7")
    ins = [torch.cat(parts) for parts in zip(base[1], gm[1])]
    words, blen = port_pk.pack_scan(*ins)
    blen = blen.numpy().astype(np.uint16)
    n_base = base[3].size
    scans = port_fused.fetch_blocks_multi(
        words.numpy().view(np.uint32),
        [(blen[:n_base], base[0].bpr), (blen[n_base:], gm[0].bpr)])
    for scan, (layout, _, w, bl) in zip(scans, (base, gm)):
        assert scan == port_native.join_blocks(w, bl.astype(np.uint16),
                                               layout.bpr)


def test_worst_case_block_fits_the_cap():
    """The pack kernel reserves CAP_WORDS words a block, the proven worst
    case: at most 64 symbols of a block carry bits, each at most a 16-bit
    code (no Huffman table here has a longer one) and 15 value bits.  The
    worst-case blocks (testing.pack_worst_case_stream) stay within it."""
    assert port_pk.CAP_WORDS == 64 * (16 + 15) // 32 == 62
    assert max(max(t.size_of) for t in (DC_LUMA, DC_CHROMA, AC_LUMA,
                                        AC_CHROMA)) <= 16
    _, blen = port_pk.pack_scan_plain(*testing.pack_worst_case_stream())
    assert blen.max() <= 32 * port_pk.CAP_WORDS
    # luma 1023s: a 16-bit code and 10 bits each, after a 9 + 11-bit DC
    assert blen.max().item() == blen[1].item() == 63 * (16 + 10) + 9 + 11


@pytest.mark.parametrize("n", [1, 128, 129, 583200])
def test_pack_kernel_buffers(n):
    """The kernel's buffers: a status word per 128-block tile after the
    counter and the total, a length per block, CAP_WORDS words a block."""
    scratch, blen, words = port_pk.PACK_KERNEL.buffers(n, torch.device("cpu"))
    assert scratch.shape == (2 + -(-n // 128),) and not scratch.any()
    assert scratch.dtype == torch.int64
    assert blen.shape == (n,) and blen.dtype == torch.int32
    assert words.shape == (n * port_pk.CAP_WORDS,)
    assert words.dtype == torch.int32


def test_plain_pack_stream_ending_on_a_word():
    """A stream whose last block ends on a word boundary with coefficient
    63 nonzero (no EOB): its empty EOB slot sits one word past the end, where
    pack_scan_plain used to index out of its buffer.  The block's words are
    those it has with another block after it."""
    s = np.zeros((2, 64), np.int16)
    s[:, 63] = 16
    dcd = torch.tensor([-40, 3], dtype=torch.int32)
    luma = torch.tensor([1, 1], dtype=torch.int32)
    stream = torch.from_numpy(s)
    words, blen = port_pk.pack_scan_plain(stream[:1], dcd[:1], luma[:1])
    assert blen.item() % 32 == 0
    both, _ = port_pk.pack_scan_plain(stream, dcd, luma)
    assert torch.equal(words, both[:words.numel()])
