"""PyTorch port: the wire codecs' host packers, device halves and mode
parsers against the JAX package's, on the CPU.

Every case of ``tests/test_wire_codec.py`` that has a counterpart in the
port, at that test's own sizes and content:

- the host packers run the same C++ (the port's copy), so their buffers
  equal JAX's (``np.array_equal``; ``None`` where JAX's is ``None``);
- each device half, fed the same buffer, equals JAX's on the CPU
  (``torch.equal`` against ``np.asarray`` of the JAX result, the port's
  carriers viewed as the unsigned types), and the input it encodes;
- the knob parsers give JAX's result for every value JAX's tests parse,
  and "unset" means raw in the port (JAX: "auto");
- the download fetchers equal the raw download, and the sticky ladder
  walks ``test_down_wire_sticky_ladder``'s sequence.

The routes (encodes, decodes, batch and pipelined) over each knob value
are ``tests/test_torch_wire_routes.py``; the kernels' models
``tests/test_torch_wire_kernel.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu import fused as jf
from libultrahdr_tpu.jpeg import native as jn
from libultrahdr_tpu.types import ImgFmt

from libultrahdr_tpu_torch import fused as pf
from libultrahdr_tpu_torch import wire
from libultrahdr_tpu_torch.jpeg import native as pn

from test_torch_jax_native import guard_jax_native

guard_jax_native()

W, H = 256, 128
_CARRIER = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16,
            np.dtype(np.int32): np.int32, np.dtype(np.int16): np.int16,
            np.dtype(np.uint8): np.uint8, np.dtype(np.int8): np.int8}


def _t(a) -> torch.Tensor:
    """A host array as the port's CPU tensor carrier of its bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(_CARRIER[a.dtype]).copy())


def _blob(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())


def _same(port_t: torch.Tensor, jax_out, what=""):
    """The port's tensor (a carrier) equals a JAX result bit for bit."""
    want = np.asarray(jax_out)
    got = port_t.numpy().view(want.dtype) if port_t.dtype.itemsize \
        == want.dtype.itemsize else port_t.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.equal(torch.from_numpy(got.copy()),
                       torch.from_numpy(want.copy())), what


# content, as tests/test_wire_codec.py makes it

def _smooth_plane(h, w, seed=0, edges=True):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v = 400 + 250 * np.sin(xx / 37.0) + 150 * np.cos(yy / 23.0)
    v += rs.rand(h, w) * 24
    if edges:
        v[:, w // 3:] += 400
        v[h // 2:, :] -= 300
    return (np.clip(v, 0, 1023).astype(np.uint16) << 6)


def _lowpass_plane(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v = 400 + 250 * np.sin(xx / 37.0 + seed) + 150 * np.cos(yy / 23.0)
    v[:, w // 3:] += 400
    v[h // 2:, :] -= 300
    return (np.clip(v, 0, 1023).astype(np.uint16) << 6)


def _interleaved(h, w, seed):
    u = _smooth_plane(h, w // 2, seed=seed, edges=False)
    v = _smooth_plane(h, w // 2, seed=seed + 1)
    uv = np.empty((h, w), np.uint16)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return uv


def _gentle_base(max_delta: float) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    a = max_delta * 0.9
    v = 500 + a * 57 * np.sin(xx / 57.0) + a * 43 * np.cos(yy / 43.0)
    return np.clip(v, 0, 1023).astype(np.uint32)


def _rgba1010102(seed=40):
    rs = np.random.RandomState(seed)
    base = _smooth_plane(H, W, seed=seed) >> 6
    g = np.clip(base + rs.randint(-3, 4, base.shape), 0, 1023)
    return np.ascontiguousarray(
        base.astype(np.uint32) | (g.astype(np.uint32) << 10)
        | (np.clip(1023 - base, 0, 1023).astype(np.uint32) << 20)
        | np.uint32(0x3) << 30)


def _f16_comp(seed=90, noisy=False):
    if noisy:
        vals = np.random.RandomState(seed).rand(H, W).astype(np.float32) * 100
    else:
        vals = (_lowpass_plane(H, W, seed=seed) >> 6).astype(np.float32)
        vals = vals / 1023.0 * 4.0
    comp = np.empty((H, W, 4), np.float16)
    comp[..., 0] = vals.astype(np.float16)
    comp[..., 1] = (vals * 0.6).astype(np.float16)
    comp[..., 2] = (4.0 - vals).astype(np.float16)
    comp[..., 3] = np.float16(1.0)
    return comp.view(np.uint16)


def _vw_scene(h, w, seed=0, hot=True):
    rs = np.random.RandomState(seed)
    y = _smooth_plane(h, w, seed=seed)
    if hot:
        n = (y >> 6).astype(np.int32)
        n[h // 4::h // 3, :] = rs.randint(0, 1024, (len(n[h // 4::h // 3]),
                                                    w))
        y = (np.clip(n, 0, 1023).astype(np.uint16) << 6)
    uv = np.empty((h // 2, w), np.uint16)
    uv[:, 0::2] = _smooth_plane(h // 2, w // 2, seed=seed + 1, edges=False)
    uv[:, 1::2] = _smooth_plane(h // 2, w // 2, seed=seed + 2)
    return y, uv


def _rung_plane(bh, bw, nzfrac, lo, hi, seed, blockwise=False):
    rs = np.random.RandomState(seed)
    c = np.zeros((bh, bw, 64), np.int16)
    c[..., 0] = rs.randint(-900, 900, (bh, bw))
    if blockwise:
        occ = rs.rand(bh, bw) < nzfrac
        nz = occ[..., None] & (rs.rand(bh, bw, 63) < 0.25)
    else:
        nz = rs.rand(bh, bw, 63) < nzfrac
    v = rs.randint(lo, hi, int(nz.sum())).astype(np.int16)
    v[v == 0] = 1
    c[..., 1:][nz] = v
    return c


# ---------------------------------------------------------------------------
# the delta rungs and the dense 10-bit fallback

_DELTA_CASES = [("luma", H, W, False, False, 7), ("uv", H // 2, W, True,
                                                   False, 7),
                ("tail", 31, 50, False, False, 7)] + [
    (f"{kind} {'2d' if two_d else '1d'}{bits}", h, W, uv, two_d, bits)
    for two_d, bits in ((True, 5), (True, 6), (True, 4), (False, 6),
                        (True, 8), (True, 3))
    for kind, h, uv in (("luma", H, False), ("uv", H // 2, True))]


@pytest.mark.parametrize("name,h,w,uv,two_d,bits", _DELTA_CASES,
                         ids=[c[0] for c in _DELTA_CASES])
def test_delta_plane_matches_jax(name, h, w, uv, two_d, bits):
    """native.pack_delta7 (both packages' C++) and _delta_decode_plane:
    the buffers equal, the port's decode equals JAX's and the input."""
    plane = _interleaved(h, w, 7) if uv else _smooth_plane(h, w, seed=6)
    want = jn.pack_delta7(plane, uv, two_d=two_d, bits=bits)
    got = pn.pack_delta7(plane, uv, two_d=two_d, bits=bits)
    assert want is not None and got is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    words, ei, ev = got
    out = wire._delta_decode_plane(_t(words), _t(ei), _t(ev), h, w, uv, bits,
                                   two_d)
    _same(out, jf._delta_decode_plane(jnp.asarray(words), jnp.asarray(ei),
                                      jnp.asarray(ev), h, w, uv, bits,
                                      two_d), name)
    np.testing.assert_array_equal(out.numpy().view(np.uint16),
                                  plane & np.uint16(0xFFC0))


def test_delta7_overflow_returns_none():
    noise = (np.random.RandomState(3).randint(0, 1024, (512, 256))
             .astype(np.uint16) << 6)
    assert pn.pack_delta7(noise, False) is None
    assert jn.pack_delta7(noise, False) is None


@pytest.mark.parametrize("mode", [m for m in jf._WIRE_LADDER])
def test_delta_wire_matches_jax(mode):
    """The one-buffer P010 delta wire at every ladder rung: the same buffer
    (or None), and its decode equals the planes."""
    y, uv = _smooth_plane(H, W, seed=30), _interleaved(H // 2, W, 31)
    want = jf.pack_delta_wire(y, uv, *mode)
    got = wire.pack_delta_wire(y, uv, *mode)
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got, want)
    yd, uvd = wire._decode_delta_wire(_t(got), H, W, mode)
    np.testing.assert_array_equal(yd.numpy().view(np.uint16), y & 0xFFC0)
    np.testing.assert_array_equal(uvd.numpy().view(np.uint16), uv & 0xFFC0)


def test_dense_10bit_matches_jax():
    """native.pack_p010_10bit and _unpack_10bit: the same stream and
    samples, the input's 10 MSBs, an unaligned tail included."""
    plane = _smooth_plane(31, 50)
    words = pn.pack_p010_10bit(plane)
    np.testing.assert_array_equal(words, jn.pack_p010_10bit(plane))
    out = wire._unpack_10bit(_t(words), plane.size)
    _same(out, jf._unpack_10bit(jnp.asarray(words), plane.size))
    np.testing.assert_array_equal(out.numpy().view(np.uint16),
                                  plane.reshape(-1) & 0xFFC0)


# ---------------------------------------------------------------------------
# the variable-width group wire

@pytest.mark.parametrize("dims", [(H, W), (126, 94), (32, 50)])
def test_vw_wire_matches_jax(dims):
    y, uv = _vw_scene(*dims)
    h, w = y.shape
    buf, mode = wire.pack_vw_wire(y, uv)
    jbuf, jmode = jf.pack_vw_wire(y, uv)
    np.testing.assert_array_equal(buf, jbuf)
    assert mode == jmode and mode[1] == buf.size
    yd, uvd = wire._vw_decode_planes(_t(buf), h, w)
    jy, juv = jf._vw_decode_planes(jnp.asarray(buf), h, w)
    _same(yd, jy, "y")
    _same(uvd, juv, "uv")
    np.testing.assert_array_equal(yd.numpy().view(np.uint16), y & 0xFFC0)


def test_vw_wire_never_overflows_on_noise():
    rs = np.random.RandomState(3)
    y = (rs.randint(0, 1024, (H, W)).astype(np.uint16) << 6)
    uv = (rs.randint(0, 1024, (H // 2, W)).astype(np.uint16) << 6)
    buf, _ = wire.pack_vw_wire(y, uv)
    np.testing.assert_array_equal(buf, jf.pack_vw_wire(y, uv)[0])
    yd, uvd = wire._vw_decode_planes(_t(buf), H, W)
    np.testing.assert_array_equal(yd.numpy().view(np.uint16), y)
    np.testing.assert_array_equal(uvd.numpy().view(np.uint16), uv)


def test_vw_wire_flat_content_is_tiny():
    y = np.full((H, W), 512 << 6, np.uint16)
    uv = np.full((H // 2, W), 512 << 6, np.uint16)
    buf, _ = wire.pack_vw_wire(y, uv)
    _, _, wyw, wuvw = wire._vw_header_words(H, W)
    assert wire._vw_header_words(H, W) == jf._vw_header_words(H, W)
    assert np.count_nonzero(buf[wyw + wuvw:]) == 0
    yd, _ = wire._vw_decode_planes(_t(buf), H, W)
    np.testing.assert_array_equal(yd.numpy().view(np.uint16), y)


@pytest.mark.parametrize("dims", [(H, W), (31, 50)])
def test_vw_chan_matches_jax(dims):
    h, w = dims
    rs = np.random.RandomState(7)
    for name, ch in [("smooth", _smooth_plane(h, w, seed=4) >> 6),
                     ("noise10", rs.randint(0, 1024, (h, w)).astype(
                         np.uint16)),
                     ("zeros", np.zeros((h, w), np.uint16)),
                     ("max", np.full((h, w), 1023, np.uint16))]:
        buf = wire.pack_vw_chan(ch)
        np.testing.assert_array_equal(buf, jf.pack_vw_chan(ch), name)
        out = wire._vw_decode_chan(_t(buf), h, w)
        _same(out, jf._vw_decode_chan(jnp.asarray(buf), h, w), name)
        np.testing.assert_array_equal(out.numpy().view(np.uint16), ch)


def test_vw_chan_rejects_wide_content():
    wide = np.random.RandomState(8).randint(0, 65536, (H, W)).astype(
        np.uint16)
    assert wire.pack_vw_chan(wide) is None and jf.pack_vw_chan(wide) is None


# ---------------------------------------------------------------------------
# the RGB wires

@pytest.mark.parametrize("bits", [2, 3, 4, 6])
def test_rgb_chan_matches_jax(bits):
    ch = _gentle_base(2.0 ** (bits - 1) - 1).astype(np.uint16)
    buf = wire.pack_rgb_chan(ch, bits)
    assert buf is not None
    np.testing.assert_array_equal(buf, jf.pack_rgb_chan(ch, bits))
    out = wire._decode_rgb_chan(_t(buf), H, W, bits)
    _same(out, jf._decode_rgb_chan(jnp.asarray(buf), H, W, bits))
    np.testing.assert_array_equal(out.numpy().view(np.uint16), ch)


@pytest.mark.parametrize("fmt,bits", [(ImgFmt.RGBA1010102, b)
                                      for b in (2, 3, 4, 6)]
                         + [(ImgFmt.RGBAF16, b) for b in (2, 4, 8)])
def test_rgb_wire_matches_jax(fmt, bits):
    """The one-buffer RGB wire at every rung of both formats: buffer,
    decode (the exact packed input) equal to JAX's."""
    base = _gentle_base(2.0 ** (bits - 1) - 1)
    if fmt == ImgFmt.RGBA1010102:
        p = np.ascontiguousarray(base | (base << 10) | ((1023 - base) << 20)
                                 | np.uint32(0x3) << 30)
    else:
        comp = np.empty((H, W, 4), np.float16)
        comp[..., 0] = (0.5 + base / 2048.0).astype(np.float16)
        comp[..., 1] = (0.5 + (1023 - base) / 2048.0).astype(np.float16)
        comp[..., 2] = (0.5 + base / 4096.0).astype(np.float16)
        comp[..., 3] = np.float16(1.0)
        p = np.ascontiguousarray(comp).view(np.uint16)
    buf = wire.pack_rgb_wire(p, fmt, bits)
    assert buf is not None
    np.testing.assert_array_equal(buf, jf.pack_rgb_wire(p, fmt, bits))
    out = wire._decode_rgb_wire(_t(buf), H, W, fmt, bits)
    _same(out, jf._decode_rgb_wire(jnp.asarray(buf), H, W, fmt, bits))
    np.testing.assert_array_equal(out.numpy().view(p.dtype), p)


def test_rgb_split_and_mixed_rungs_match_jax():
    """A noisy channel rides a wider rung (the JAX decisions), and a
    varying alpha refuses the wire."""
    rs = np.random.RandomState(9)
    base = _gentle_base(1.0)
    noisy = np.clip(base + rs.randint(-6, 7, base.shape), 0, 1023
                    ).astype(np.uint32)
    p = np.ascontiguousarray(base | (noisy << 10) | ((1023 - base) << 20)
                             | np.uint32(0x3) << 30)
    chans, alpha = wire._split_rgb_channels(p, ImgFmt.RGBA1010102)
    jchans, jalpha = jf._split_rgb_channels(p, ImgFmt.RGBA1010102)
    assert alpha == jalpha == 3
    for a, b in zip(chans, jchans):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pn.extract_channel10(p, 10),
                                  jn.extract_channel10(p, 10))
    for bits, fits in ((2, [True, False]), (6, [True, True])):
        assert [wire.pack_rgb_chan(c, bits) is not None
                for c in chans[:2]] == fits
        assert [jf.pack_rgb_chan(c, bits) is not None
                for c in jchans[:2]] == fits
    q = _rgba1010102()
    q[0, 0] &= np.uint32(0x3FFFFFFF)
    assert wire.pack_rgb_wire(q, ImgFmt.RGBA1010102, 5) is None
    assert jf.pack_rgb_wire(q, ImgFmt.RGBA1010102, 5) is None
    assert wire._split_rgb_channels(q, ImgFmt.RGBA1010102)[1] is None


def test_rgb_ladders_reach_what_jax_reaches():
    """The port's f16 ladder leaves out JAX's rungs 10 and 12, which the
    host packer refuses, so every channel lands on the rung JAX's does."""
    assert wire._RGB_LADDERS[ImgFmt.RGBA1010102] \
        == jf._RGB_LADDERS[ImgFmt.RGBA1010102]
    assert tuple(b for b in jf._RGB_LADDERS[ImgFmt.RGBAF16] if b <= 8) \
        == wire._RGB_LADDERS[ImgFmt.RGBAF16]
    wide = np.random.RandomState(8).randint(0, 65536, (H, W)).astype(
        np.uint16)
    assert all(jf.pack_rgb_chan(wide, b) is None for b in (10, 12))


# ---------------------------------------------------------------------------
# the API-1 wires

def _api1_planes(seed=50, lowpass=False):
    mk = _lowpass_plane if lowpass else _smooth_plane
    y, uv = mk(H, W, seed=seed), mk(H // 2, W, seed=seed + 1)
    rs = np.random.RandomState(seed)
    sdr = [((mk(h, w, seed=seed + 2 + i) >> 8) + rs.randint(0, 2, (h, w)))
           .astype(np.uint8)
           for i, (h, w) in enumerate(((H, W), (H // 2, W // 2),
                                       (H // 2, W // 2)))]
    return y, uv, sdr


@pytest.mark.parametrize("hb,sb", [(3, 3), (4, 3), (5, 4), (6, 6)])
def test_api1_wire_matches_jax(hb, sb):
    y, uv, sdr = _api1_planes(lowpass=hb < 5)
    buf = wire.pack_api1_wire(y, uv, sdr, hb, sb)
    jbuf = jf.pack_api1_wire(y, uv, sdr, hb, sb)
    assert (buf is None) == (jbuf is None)
    if buf is None:
        return
    np.testing.assert_array_equal(buf, jbuf)
    hy, huv, sp = wire._decode_api1_wire(_t(buf), H, W, hb, sb)
    jy, juv, jsp = jf._decode_api1_wire(jnp.asarray(buf), H, W, hb, sb)
    _same(hy, jy, "hdr y")
    _same(huv, juv, "hdr uv")
    for got, want, p in zip(sp, jsp, sdr):
        _same(got, want, "sdr")
        np.testing.assert_array_equal(got.numpy(), p)


def test_api1_vw_wire_matches_jax():
    rs = np.random.RandomState(31)
    y = (rs.randint(0, 1024, (H, W)).astype(np.uint16) << 6)
    uv = (rs.randint(0, 1024, (H // 2, W)).astype(np.uint16) << 6)
    sdr = [rs.randint(0, 256, (H, W)).astype(np.uint8),
           rs.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
           rs.randint(0, 256, (H // 2, W // 2)).astype(np.uint8)]
    buf = wire.pack_api1_vw_wire(y, uv, sdr)
    np.testing.assert_array_equal(buf, jf.pack_api1_vw_wire(y, uv, sdr))
    hy, huv, sp = wire._decode_api1_vw(_t(buf), H, W)
    jy, juv, jsp = jf._decode_api1_vw(jnp.asarray(buf), H, W)
    _same(hy, jy)
    _same(huv, juv)
    np.testing.assert_array_equal(hy.numpy().view(np.uint16), y)
    for got, want, p in zip(sp, jsp, sdr):
        _same(got, want)
        np.testing.assert_array_equal(got.numpy(), p)
    for hb, sb in wire._API1_LADDER:
        assert wire.pack_api1_wire(y, uv, sdr, hb, sb) is None


# ---------------------------------------------------------------------------
# the coefficient wires

def _planes_with_escapes(seed, shapes, lo, hi):
    rs = np.random.RandomState(seed)
    planes = []
    for bh, bw in shapes:
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-500, 500, (bh, bw))
        c[..., 1:20] = rs.randint(lo, hi, (bh, bw, 19))
        c[0, 0, 30] = 900
        c[-1, -1, 63] = -1023
        planes.append(c)
    return planes


@pytest.mark.parametrize("bits,lo,hi", [(4, -6, 7), (3, -4, 4), (5, -9, 10)])
def test_coeff_wire_n_matches_jax(bits, lo, hi):
    shapes = ((6, 10), (3, 5))
    planes = _planes_with_escapes(5 + bits, shapes, lo, hi)
    planes[0][0, 0, 40] = 7 if bits == 3 else 40
    blob = pf.pack_coeff_wire_n(planes, bits)
    assert blob is not None and blob == jf.pack_coeff_wire_n(planes, bits)
    # an odd start: the blob's sections are read unaligned
    out = wire._unpack_coeff_wire_multi(
        torch.cat([torch.zeros(1, dtype=torch.uint8), _blob(blob)])[1:],
        shapes, f"i{bits}")
    want = jf._unpack_coeff_wire_n(jnp.asarray(np.frombuffer(blob, np.uint8)),
                                   shapes, bits)
    for c, o, j in zip(planes, out, want):
        _same(o, j)
        np.testing.assert_array_equal(o.numpy(), c.astype(np.int32))


def test_coeff_wire_overflows_match_jax():
    rs = np.random.RandomState(6)
    c = np.zeros((64, 64, 64), np.int16)
    c[..., 1:] = rs.randint(-200, 200, (64, 64, 63))
    assert pf.pack_coeff_wire4([c]) is None and jf.pack_coeff_wire4([c]) is None
    d = np.zeros((64, 64, 64), np.int16)
    d[..., 1:] = np.random.RandomState(10).randint(1, 5, (64, 64, 63))
    assert pf.pack_coeff_wire_sparse([d]) is None
    assert jf.pack_coeff_wire_sparse([d]) is None


def test_coeff_wire_sparse_matches_jax():
    rs = np.random.RandomState(9)
    shapes = ((6, 10), (3, 5))
    planes = []
    for bh, bw in shapes:
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-500, 500, (bh, bw))
        nz = rs.rand(bh, bw, 63) < 0.08
        c[..., 1:][nz] = rs.randint(-120, 121, int(nz.sum()))
        c[0, 0, 30], c[-1, -1, 63], c[0, 0, 1] = 900, -1023, -128
        planes.append(c)
    blob = pf.pack_coeff_wire_sparse(planes)
    assert blob == jf.pack_coeff_wire_sparse(planes)
    out = wire._unpack_coeff_wire_multi(_blob(blob), shapes, "sp")
    want = jf._unpack_coeff_wire_sparse(
        jnp.asarray(np.frombuffer(blob, np.uint8)), shapes)
    for c, o, j in zip(planes, out, want):
        _same(o, j)
        np.testing.assert_array_equal(o.numpy(), c.astype(np.int32))


def test_coeff_wire_ladder_matches_jax():
    rs = np.random.RandomState(11)
    c = np.zeros((40, 40, 64), np.int16)
    nz = rs.rand(40, 40, 63) < 0.05
    c[..., 1:][nz] = rs.randint(-3, 4, int(nz.sum()))
    c[..., 0] = rs.randint(-200, 200, (40, 40))
    assert [k for _, k in pf.COEFF_WIRE_LADDER] \
        == [k for _, k in jf.COEFF_WIRE_LADDER]
    for (pack, k), (jpack, _) in zip(pf.COEFF_WIRE_LADDER,
                                     jf.COEFF_WIRE_LADDER):
        assert pack([c]) == jpack([c]), k


@pytest.mark.parametrize("kind,plane", [
    ("ga", _rung_plane(60, 64, 0.015, -200, 200, 4)),
    ("gb", _rung_plane(60, 64, 0.05, -135, 135, 4)),
    ("gc", _rung_plane(60, 64, 0.11, -135, 135, 4)),
    ("gd", _rung_plane(60, 64, 0.28, -40, 40, 4)),
    ("ta", _rung_plane(60, 64, 0.05, -90, 90, 5, blockwise=True)),
    ("tb", _rung_plane(60, 64, 0.12, -90, 90, 6, blockwise=True)),
    ("tc", _rung_plane(60, 64, 0.28, -90, 90, 7, blockwise=True)),
    ("sr", _rung_plane(60, 64, 0.40, -40, 40, 8)),
    ("i8", _rung_plane(60, 64, 0.10, -140, 140, 12)),
    ("i16", _rung_plane(60, 64, 0.95, -2000, 2000, 9)),
])
def test_coeff_plane_rungs_match_jax(kind, plane):
    """Every rung of a plane: the same bytes and static size, an unpack
    equal to JAX's (started at an odd offset) and lossless."""
    blob = wire._pack_plane(plane, kind)
    assert blob is not None and blob == jf._pack_plane(plane, kind)
    assert len(blob) == wire._plane_rung_size(60, 64, kind) \
        == jf._plane_rung_size(60, 64, kind)
    out, off = wire._unpack_plane(
        torch.cat([torch.zeros(3, dtype=torch.uint8), _blob(blob)]), 3, 60,
        64, kind)
    jout, joff = jf._unpack_plane(jnp.asarray(np.frombuffer(blob, np.uint8)),
                                  0, 60, 64, kind)
    assert off == joff + 3 == len(blob) + 3
    _same(out, jout, kind)
    np.testing.assert_array_equal(out.numpy(), plane.astype(np.int32))


def test_coeff_wire_gap_rung_wide_gaps():
    c = np.zeros((20, 20, 64), np.int16)
    c[0, 0, 1], c[19, 19, 63] = -300, 7
    blob = wire._pack_plane(c, "ga")
    assert blob == jf._pack_plane(c, "ga")
    out, _ = wire._unpack_plane(_blob(blob), 0, 20, 20, "ga")
    np.testing.assert_array_equal(out.numpy(), c.astype(np.int32))


def test_coeff_wire_best_matches_jax():
    """pack_coeff_wire_best: the same blob and kind as JAX's on mixed
    planes (per-plane rungs), a dense plane (the terminal i16) and tiny
    planes (one kind); each unpack equals JAX's and the planes."""
    rs = np.random.RandomState(12)
    shapes = ((48, 64), (24, 32), (24, 32), (64, 64))
    mixed = []
    for i, (bh, bw) in enumerate(shapes):
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-500, 500, (bh, bw))
        if i < 3:
            nz = rs.rand(bh, bw, 63) < 0.05
            c[..., 1:][nz] = rs.randint(-3, 4, int(nz.sum()))
        else:
            c[..., 1:] = rs.randint(-150, 151, (bh, bw, 63))
        mixed.append(c)
    dense = [np.random.RandomState(14).randint(-2000, 2000, (24, 24, 64))
             .astype(np.int16)]
    tiny = []
    rs = np.random.RandomState(13)
    for bh, bw in ((4, 6), (2, 3)):
        c = np.zeros((bh, bw, 64), np.int16)
        c[..., 0] = rs.randint(-100, 100, (bh, bw))
        nz = rs.rand(bh, bw, 63) < 0.03
        c[..., 1:][nz] = rs.randint(-2, 3, int(nz.sum()))
        tiny.append(c)
    for planes, check in ((mixed, lambda k: len(k.split(",")) == 4),
                          (dense, lambda k: k == "i16"),
                          (tiny, lambda k: k == "i16")):
        blob, kind = pf.pack_coeff_wire_best(planes)
        assert (blob, kind) == jf.pack_coeff_wire_best(planes)
        assert check(kind), kind
        shp = tuple(c.shape[:2] for c in planes)
        out = wire._unpack_coeff_wire_multi(_blob(blob), shp, kind)
        want = jf._unpack_coeff_wire_multi(
            jnp.asarray(np.frombuffer(blob, np.uint8)), shp, kind)
        for c, o, j in zip(planes, out, want):
            _same(o, j)
            np.testing.assert_array_equal(o.numpy(), c.astype(np.int32))


def test_coeff_wire_best_picks_smallest_fitting_fast_rung():
    c = _rung_plane(60, 64, 0.05, -90, 90, 15, blockwise=True)
    blob, kind = wire.pack_coeff_wire_best([c])
    assert (blob, kind) == jf.pack_coeff_wire_best([c])
    sizes = {k: len(b) for k in wire._PLANE_KINDS
             if (b := wire._pack_plane(c, k)) is not None}
    assert wire._FAST_KINDS == jf._FAST_KINDS
    assert len(blob) == min(sizes[k] for k in sizes if k in wire._FAST_KINDS)


def test_int8_escape_upload_matches_jax():
    """pack_coeffs_for_upload and _reconstruct_coeffs (the JAX
    upload_coeff_planes' wire, the blob's i8 rung in the port), and the
    i8 blob's planes on the port's upload route; the port's
    upload_coeff_planes stays raw with UHDR_TPU_WIRE set."""
    planes = _planes_with_escapes(21, ((6, 10), (3, 5)), -128, 128)
    wide = np.random.RandomState(3).randint(-300, 300, (40, 40, 64)).astype(
        np.int16)
    for c in planes:
        got, want = wire.pack_coeffs_for_upload(c), jf.pack_coeffs_for_upload(c)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        out = wire._reconstruct_coeffs(*(_t(a) for a in got))
        _same(out, jf._reconstruct_coeffs(*(jnp.asarray(a) for a in want)))
    assert wire.pack_coeffs_for_upload(wide) is None
    assert jf.pack_coeffs_for_upload(wide) is None
    blob = pf.pack_coeff_wire(planes)
    assert blob == jf.pack_coeff_wire(planes)
    shapes = tuple(c.shape[:2] for c in planes)
    ups = wire.upload_coeff_blob(
        (torch.from_numpy(np.frombuffer(blob, np.uint8).copy()), "i8",
         shapes), torch.device("cpu"))
    for c, u in zip(planes, ups):
        np.testing.assert_array_equal(u.numpy(), c.astype(np.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UHDR_TPU_WIRE", "auto")
        raw = pf.upload_coeff_planes(planes + [wide], torch.device("cpu"))
    for c, u in zip(planes + [wide], raw):
        assert u.dtype == torch.int16
        np.testing.assert_array_equal(u.numpy(), c)


# ---------------------------------------------------------------------------
# the download wire

def _smooth_1010102(h=H, w=W, seed=70):
    base = (_lowpass_plane(h, w, seed=seed) >> 6).astype(np.uint32)
    return base | ((1023 - base) << 10) | (base << 20) | np.uint32(0x3) << 30


def _noise_1010102(seed=12, h=H, w=W):
    return (np.random.RandomState(seed).randint(0, 1 << 30, (h, w))
            .astype(np.uint32) | np.uint32(0x3) << 30)


@pytest.mark.parametrize("name,bits", [("smooth", 3), ("smooth", 4),
                                       ("rgba", 6), ("tail", 4),
                                       ("noise", 3)])
def test_down_wire_1010102_matches_jax(name, bits):
    """_pack_down_wire_1010102 (the plain version on the CPU) equals JAX's
    wire word for word; the host unpack gives the output back, or None on
    an overflow (noise)."""
    h, w = (31, 50) if name == "tail" else (H, W)
    packed = {"smooth": lambda: _smooth_1010102(),
              "rgba": lambda: _rgba1010102(seed=70),
              "tail": lambda: _smooth_1010102(h, w, seed=71),
              "noise": lambda: _noise_1010102()}[name]()
    got = wire._pack_down_wire_1010102(_t(packed), h=h, w=w, bits=bits)
    jwire = np.asarray(jf._pack_down_wire_1010102(jnp.asarray(packed), h=h,
                                                  w=w, bits=bits))
    _same(got, jwire)
    out = wire.unpack_down_wire_1010102(got.numpy().view(np.uint32), h, w,
                                        bits)
    want = jf.unpack_down_wire_1010102(jwire, h, w, bits)
    if name == "noise":
        assert out is None and want is None
    else:
        np.testing.assert_array_equal(out, packed)
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("bits", [6, 8])
def test_down_wire_f16_matches_jax(bits):
    comp = _f16_comp()
    got = wire._pack_down_wire_f16(_t(comp), h=H, w=W, bits=bits)
    jwire = np.asarray(jf._pack_down_wire_f16(jnp.asarray(comp), h=H, w=W,
                                              bits=bits))
    _same(got, jwire)
    out = wire.unpack_down_wire_f16(got.numpy().view(np.uint32), H, W, bits)
    np.testing.assert_array_equal(out, comp)
    np.testing.assert_array_equal(out, jf.unpack_down_wire_f16(jwire, H, W,
                                                               bits))


@pytest.mark.parametrize("kind", ["smooth", "noise", "f16", "f16 noise"])
def test_fetch_packed_matches_raw(monkeypatch, kind):
    """fetch_packed_1010102 / fetch_packed_f16 with UHDR_TPU_WIRE_DOWN
    auto: the output equals the raw download (the wire on smooth content,
    raw after an overflow); unset, raw."""
    if kind.startswith("f16"):
        packed, fetch = _f16_comp(seed=91, noisy="noise" in kind), \
            wire.fetch_packed_f16
    else:
        packed = _rgba1010102(seed=73) if kind == "smooth" \
            else _noise_1010102(13)
        fetch = wire.fetch_packed_1010102
    wire._DOWN_STICKY.clear()
    wire.RODE.clear()
    monkeypatch.setenv("UHDR_TPU_WIRE_DOWN", "auto")
    np.testing.assert_array_equal(fetch(_t(packed), h=H, w=W), packed)
    assert (wire.RODE["down:raw"] == 1) == ("noise" in kind)
    monkeypatch.delenv("UHDR_TPU_WIRE_DOWN")
    np.testing.assert_array_equal(fetch(_t(packed), h=H, w=W), packed)
    assert wire.RODE["down:raw"] == 1 + ("noise" in kind)
    wire._DOWN_STICKY.clear()


def test_down_wire_sticky_ladder(monkeypatch):
    """test_down_wire_sticky_ladder's sequence on the port: 4, then 6 on
    the first frame; the rung kept for the shape starts the next."""
    h = w = 192
    ch = (512 + np.random.RandomState(3).randint(-6, 7, (h, w))).astype(
        np.uint32)
    packed = ch | (ch << 10) | (ch << 20) | np.uint32(0x3) << 30
    dev = _t(packed)
    monkeypatch.setenv("UHDR_TPU_WIRE_DOWN", "auto")
    wire._DOWN_STICKY.clear()
    calls = []
    orig = wire._pack_down_wire_1010102

    def spy(p, *, h, w, bits, cap=wire._DOWN_ESC):
        calls.append(bits)
        return orig(p, h=h, w=w, bits=bits, cap=cap)
    monkeypatch.setattr(wire, "_pack_down_wire_1010102", spy)
    np.testing.assert_array_equal(wire.fetch_packed_1010102(dev, h=h, w=w),
                                  packed)
    assert calls[0] == 4 and 6 in calls
    sticky = wire._DOWN_STICKY.get(("1010102", h, w))
    calls.clear()
    np.testing.assert_array_equal(wire.fetch_packed_1010102(dev, h=h, w=w),
                                  packed)
    assert calls == [6] if sticky == 6 else (sticky == 0 and calls == [])
    monkeypatch.setenv("UHDR_TPU_WIRE_DOWN", "4")
    calls.clear()
    wire.fetch_packed_1010102(dev, h=h, w=w)
    assert calls == [4]                       # a pinned width: no ladder
    wire._DOWN_STICKY.clear()


# ---------------------------------------------------------------------------
# the knobs

@pytest.mark.parametrize("value", ["2d6", "1d7", "garbage", "vw", "auto",
                                   "2d5", "1d2", "2d9", "", " VW "])
def test_wire_mode_parse(monkeypatch, value):
    monkeypatch.setenv("UHDR_TPU_WIRE", value)
    assert wire._wire_mode() == jf._wire_mode()


@pytest.mark.parametrize("value", ["raw", "h5s3", "garbage", "auto", "vw",
                                   "h9s3", "h4s3"])
def test_api1_wire_ladder_parse(monkeypatch, value):
    monkeypatch.setenv("UHDR_TPU_WIRE_API1", value)
    assert wire._api1_wire_ladder() == jf._api1_wire_ladder()


@pytest.mark.parametrize("value", ["raw", "6", "garbage", "auto", "2", "9",
                                   ""])
def test_down_wire_bits_parse(monkeypatch, value):
    monkeypatch.setenv("UHDR_TPU_WIRE_DOWN", value)
    assert wire._down_wire_bits() == jf._down_wire_bits()
    assert wire._down_wire_bits(8) == jf._down_wire_bits(8)


def test_unset_knobs_mean_raw(monkeypatch):
    """Unset, every knob is the port's raw route (JAX: its wires)."""
    for k in ("UHDR_TPU_WIRE", "UHDR_TPU_WIRE_API1", "UHDR_TPU_WIRE_DOWN"):
        monkeypatch.delenv(k, raising=False)
    assert wire._wire_mode() == ()
    assert jf._wire_mode() == ("vw",) + jf._WIRE_LADDER
    assert wire._api1_wire_ladder() == ()
    assert jf._api1_wire_ladder() == jf._API1_LADDER
    assert wire._down_wire_bits() == 0 and jf._down_wire_bits() == 4
    assert not wire.coeff_wire_enabled() and not wire.down_wire_enabled()
    y, uv = _vw_scene(H, W)
    assert wire._pack_wire_auto(y, uv) == (None, None)
    monkeypatch.setenv("UHDR_TPU_WIRE", "auto")
    assert wire._pack_wire_auto(y, uv)[1][0] == "vw"
    assert wire.coeff_wire_enabled()
