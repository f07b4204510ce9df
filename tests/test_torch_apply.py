"""PyTorch port: the apply-gainmap stage of the decode against the JAX
package, on the same seeded inputs.

Tolerance (``testing.check_decoded_close``): the per-pixel math is the same
float32 operation sequence in both, but the transcendentals (pow, log2,
exp2, log) of the two frameworks may differ by an ulp, and the LUT grids of
the math turn such an ulp into one grid step now and then.  So a 10-bit
code equals the other or is its neighbour among the codes the output's
65536-entry OETF grid can produce (within 1 away from black), on at most
5e-3 of the samples, and RGBAF16 half-float patterns are equal except on at
most 1e-3 of the samples, which are within 4 ulps (one step of the
1024-entry gain grid).  The IDW upsample is bit-identical (the same float32
operations in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu.ops import apply as jax_apply
from libultrahdr_tpu.ops import idw as jax_idw
from libultrahdr_tpu.ops import pallas_apply
from libultrahdr_tpu.types import ColorGamut as JaxGamut
from libultrahdr_tpu.types import ColorTransfer as JaxTransfer
from libultrahdr_tpu.types import GainMapMetadata as JaxMetadata

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.ops import apply as port_apply
from libultrahdr_tpu_torch.ops import apply_kernel as port_ak
from libultrahdr_tpu_torch.ops import idw as port_idw

from test_torch_jax_native import guard_jax_native

guard_jax_native()

OUTPUTS = [JaxTransfer.HLG, JaxTransfer.PQ, JaxTransfer.LINEAR]


def _inputs(h, w, seed, chans, gamma=1.0):
    """Seeded SDR YUV (3,h,w) f32 with centred chroma, u8 gain (chans,h,w)
    and metadata arrays, as tests/test_pallas_apply.py makes them."""
    rs = np.random.RandomState(seed)
    sdr = rs.rand(3, h, w).astype(np.float32)
    sdr[1:] -= 0.5
    gain_u8 = rs.randint(0, 256, (chans, h, w)).astype(np.uint8)
    meta = {"gamma": np.full(3, gamma, np.float32),
            "min_content_boost": np.array([1.0, 1.0, 1.0], np.float32),
            "max_content_boost": np.array([4.9, 4.9, 4.9], np.float32),
            "offset_sdr": np.full(3, 1e-7, np.float32),
            "offset_hdr": np.full(3, 1e-7, np.float32)}
    return sdr, gain_u8, meta


def _pallas(sdr, gain_u8, meta, weight, out_ct, sdr_cg, hdr_cg, use_base_cg):
    g = np.broadcast_to(gain_u8, (3,) + gain_u8.shape[1:])
    return np.asarray(pallas_apply.apply_gainmap_pallas(
        jnp.asarray(sdr), jnp.asarray(g).astype(jnp.float32) / 255.0,
        pallas_apply.meta_to_rows(meta), weight, out_ct=out_ct,
        sdr_cg=sdr_cg, hdr_cg=hdr_cg, use_base_cg=use_base_cg,
        interpret=True))


def _plain(sdr, gain_u8, meta, weight, out_ct, sdr_cg, hdr_cg, use_base_cg):
    return port_ak.apply_gainmap_plain(
        torch.from_numpy(sdr), torch.from_numpy(gain_u8).float() / 255.0,
        port_ak.meta_to_rows(meta), weight, out_ct=int(out_ct),
        sdr_cg=int(sdr_cg), hdr_cg=int(hdr_cg), use_base_cg=use_base_cg)


@pytest.mark.parametrize("chans", [1, 3])
@pytest.mark.parametrize("use_base_cg", [False, True])
@pytest.mark.parametrize("out_ct", OUTPUTS)
def test_plain_matches_pallas_kernel(out_ct, use_base_cg, chans):
    """apply_gainmap_plain against the TPU kernel in interpret mode."""
    sdr, gain_u8, meta = _inputs(32, 64, chans, chans)
    args = (sdr, gain_u8, meta, 0.8, out_ct, JaxGamut.DISPLAY_P3,
            JaxGamut.BT2100, use_base_cg)
    want, got = _pallas(*args), _plain(*args)
    testing.check_decoded_close(got, want, int(out_ct))


def test_plain_matches_pallas_kernel_ragged_gamma_weight():
    """A ragged size the TPU kernel pads, gamma != 1 (the pow branch) and a
    fractional weight."""
    sdr, gain_u8, meta = _inputs(50, 70, 3, 3, gamma=1.571)
    args = (sdr, gain_u8, meta, 0.31, JaxTransfer.HLG, JaxGamut.BT709,
            JaxGamut.DISPLAY_P3, True)
    want, got = _pallas(*args), _plain(*args)
    assert got.shape == (50, 70) and got.dtype == torch.int32
    testing.check_decoded_close(got, want, port.ColorTransfer.HLG)


@pytest.mark.parametrize("out_ct", OUTPUTS)
@pytest.mark.parametrize("scale_k,chans", [(1, 3), (2, 1), (4, 1), (4, 3)])
def test_apply_gainmap_core_matches_jax(scale_k, chans, out_ct):
    """The port's apply_gainmap_core (IDW at scale > 1, then the plain
    apply on CPU tensors) against the JAX package's XLA path."""
    h, w = 48, 80
    sdr, _, meta = _inputs(h, w, 10 + scale_k, 1, gamma=1.2)
    rs = np.random.RandomState(scale_k * chans)
    gain_u8 = rs.randint(0, 256, (chans, h // scale_k, w // scale_k)) \
        .astype(np.uint8)
    kw = dict(scale_k=scale_k, weight=np.float32(0.7),
              sdr_cg=JaxGamut.DISPLAY_P3, hdr_cg=JaxGamut.BT2100,
              use_base_cg=False)
    want = np.asarray(jax_apply.apply_gainmap_core(
        jnp.asarray(sdr), jnp.asarray(gain_u8), meta, out_ct=out_ct, **kw))
    got = port_apply.apply_gainmap_core(
        torch.from_numpy(sdr), torch.from_numpy(gain_u8), meta,
        out_ct=int(out_ct), **kw)
    testing.check_decoded_close(got, want, int(out_ct))


@pytest.mark.parametrize("chans", [1, 3])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_idw_upsample_matches_jax(k, chans):
    rs = np.random.RandomState(k + chans)
    m = rs.randint(0, 256, (chans, 7, 9)).astype(np.float32) / 255.0
    want = np.asarray(jax_idw.idw_upsample(jnp.asarray(m), k, 7 * k, 9 * k))
    got = port_idw.idw_upsample(torch.from_numpy(m), k, 7 * k, 9 * k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_idw.shepards_weight_tables(k),
                                  jax_idw.shepards_weight_tables(k))


@pytest.mark.parametrize("chans", [1, 3])
def test_apply_gain_matches_jax(chans):
    """The per-channel gain (gamma 1 / 1.571 / 2.2, offsets, weight 0.7).
    Tolerance: the two frameworks' pow/log2/exp2 differ by ulps (relative
    1e-5, allowed on any sample), which now and then moves a gain across a
    step of the 1024-entry gain grid, a factor max_boost**(weight/1023)
    (relative <= 1.6e-3 here), allowed on at most 1e-2 of the samples."""
    rs = np.random.RandomState(chans)
    rgb = rs.rand(3, 40, 56).astype(np.float32)
    gain = (rs.randint(0, 256, (chans, 40, 56)) / 255.0).astype(np.float32)
    meta = {"gamma": np.array([1.0, 1.571, 2.2], np.float32),
            "min_content_boost": np.array([1.0, 0.9, 1.1], np.float32),
            "max_content_boost": np.array([4.9, 3.0, 2.5], np.float32),
            "offset_sdr": np.array([1e-7, 0.0, 1.0 / 64], np.float32),
            "offset_hdr": np.array([1e-7, 0.5, 1.0 / 64], np.float32)}
    want = np.asarray(jax_apply.apply_gain(jnp.asarray(rgb), jnp.asarray(gain),
                                           meta, np.float32(0.7)))
    got = port_apply.apply_gain(list(torch.from_numpy(rgb)),
                                torch.from_numpy(gain),
                                port_ak.meta_to_rows(meta), 0.7)
    got = torch.stack(got).numpy()
    rel = np.abs(got.astype(np.float64) / want - 1.0)
    assert rel.max() <= 1.6e-3
    assert (rel > 1e-5).mean() <= 1e-2


def test_metadata_rows_and_weight_match_jax():
    """The gain-map state carried into the kernel: metadata_to_arrays,
    meta_to_rows and gainmap_weight give the JAX package's values."""
    jmd, pmd = JaxMetadata(), port.GainMapMetadata()
    for md in (jmd, pmd):
        md.max_content_boost[:] = [4.9, 3.0, 2.5]
        md.min_content_boost[:] = [1.0, 0.9, 1.1]
        md.gamma[:] = [1.0, 1.571, 2.2]
        md.offset_sdr[:] = [1e-7, 0.0, 1.0 / 64]
        md.offset_hdr[:] = [1e-7, 0.5, 1.0 / 64]
    ja, pa = jax_apply.metadata_to_arrays(jmd), \
        port_apply.metadata_to_arrays(pmd)
    assert ja.keys() == pa.keys()
    for key in ja:
        assert pa[key].dtype == np.float32
        np.testing.assert_array_equal(pa[key], ja[key])
    np.testing.assert_array_equal(port_ak.meta_to_rows(pa),
                                  pallas_apply.meta_to_rows(ja))
    for boost, lo, hi in ((3.4028235e38, 1.0, 4.9), (2.0, 1.0, 4.9),
                          (1.0, 1.0, 4.9), (8.0, 1.5, 4.0)):
        assert port_apply.gainmap_weight(boost, lo, hi) == \
            jax_apply.gainmap_weight(boost, lo, hi)


def test_apply_dispatch_never_falls_back():
    """CPU tensors take the plain version; the kernel wrapper refuses CPU
    tensors, and a device without an implementation raises."""
    sdr, gain_u8, meta = _inputs(8, 16, 0, 1)
    rows = port_ak.meta_to_rows(meta)
    s, g = torch.from_numpy(sdr), torch.from_numpy(gain_u8).float() / 255.0
    kw = dict(out_ct=port.ColorTransfer.HLG, sdr_cg=port.ColorGamut.BT709,
              hdr_cg=port.ColorGamut.BT2100, use_base_cg=True)
    out = port_ak.apply_gainmap(s, g, rows, 1.0, **kw)
    assert out.shape == (8, 16) and out.dtype == torch.int32
    assert (testing.codes_1010102(out)[3] == 3).all()
    before = port_ak.APPLY_KERNEL.launches
    with pytest.raises(ValueError):
        port_ak.APPLY_KERNEL(s, g, rows, 1.0, **kw)
    assert port_ak.APPLY_KERNEL.launches == before
    with pytest.raises(port.UhdrError):
        port_ak.apply_gainmap(s.to("meta"), g.to("meta"), rows, 1.0, **kw)
    with pytest.raises(port.UhdrError):
        port_ak.apply_gainmap(s, g, rows, 1.0, **dict(
            kw, out_ct=port.ColorTransfer.SRGB))


@pytest.mark.parametrize("chans", [1, 3])
@pytest.mark.parametrize("gamma", [1.0, 1.571])
@pytest.mark.parametrize("out_ct", OUTPUTS)
def test_table_formulation_matches_plain(out_ct, gamma, chans):
    """The apply kernel's design on the CPU: tables of the sRGB inverse,
    the gain factors and the 10-bit OETF codes, made by the plain ops on
    their LUT grids and gathered at lut_quantize's index
    (testing.apply_gainmap_tables), equal apply_gainmap_plain bit for bit
    on testing.apply_edge_inputs (grid ties, values outside [0, 1], NaN).
    Every tensor here has a multiple of 64 elements (and fewer than 32768
    per op, one chunk of PyTorch's CPU loops): PyTorch's CPU elementwise
    ops run a vector body and a scalar tail, whose pow/log/exp may differ
    by an ulp, and a table entry must meet the same code as the pixel."""
    sdr, gain, rows = (torch.from_numpy(a) if i < 2 else a for i, a in
                       enumerate(testing.apply_edge_inputs(16, 64, chans,
                                                           gamma)))
    kw = dict(out_ct=int(out_ct), sdr_cg=port.ColorGamut.DISPLAY_P3,
              hdr_cg=port.ColorGamut.BT2100, use_base_cg=gamma != 1.0)
    want = port_ak.apply_gainmap_plain(sdr, gain, rows, 0.8, **kw)
    got = testing.apply_gainmap_tables(sdr, gain, rows, 0.8, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_plain_tables_on_their_grids():
    """testing.apply_tables_plain: the sRGB table runs from 0 to 1 on the
    1024 grid; the code tables run from 0 to 1023 and step down by at most
    1 (the float32 PQ curve falls by a code at a few boundaries, an ulp of
    pow, so a kernel cannot look a code up by thresholds on its input)."""
    t = testing.apply_tables_plain(torch.device("cpu"))
    assert t["srgb"].shape == (1024,) and t["srgb"].dtype == torch.float32
    assert t["srgb"][0] == 0.0 and t["srgb"][-1] == 1.0
    for name in ("hlg", "pq"):
        codes = t[name].numpy()
        assert codes.shape == (65536,) and codes[0] == 0 \
            and codes[-1] == 1023 and np.diff(codes).min() >= -1
