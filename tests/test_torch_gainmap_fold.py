"""PyTorch port: the one-pass gain map of the fused encodes against the JAX
package's compiled fused programs.

Every fused encode of the JAX package (``fused.py`` API-0 P010, RGB,
YUV444_10 and the API-1 one-pass; ``parallel/batch.py``) inlines
``ops/gainmap.encode_gain`` under a jit whose boosts and gamma are
compile-time constants.  XLA's algebraic simplifier then folds the
normalisation to ``log(gain) * c``: for HLG and gamma 1, c = 159.919785, and
a clipped gain (== max boost) codes 254.99998 -> 254, where the function
called on its own (boosts traced, as on the general path) and libultrahdr's
encodeGain write 255.  The port's fused routes compute the folded form
(``gainmap.encode_gain_folded``), its general path the unfolded one.

Contracts:

- the folded constants and op form equal those in the optimized HLO;
- the port's fused map against the jitted JAX stages, on the same SDR
  planes: within 1 on at most 1e-3 of the samples (HLG); PQ within 1 on no
  larger share than the JAX stages run without jit differ from the jitted
  ones, or 1e-3.  XLA's CPU backend contracts ``c2 - c3 * val`` of the PQ
  inverse OETF (``ops/colors.pq_inv_oetf``) into a fused multiply-add,
  which the port does not imitate; un-jitted JAX and the port round it;
- the port's general-path map against the un-jitted JAX function: within 1
  on at most 1e-3, 255 on every clipped sample;
- the encode's base and gain-map scans against the JAX file's: equal
  except where x/q lies within 1e-3 of a rounding tie.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.ops import colors as jax_colors
from libultrahdr_tpu.ops import gainmap as jax_gainmap
from libultrahdr_tpu.ops import pixel as jax_pixel
from libultrahdr_tpu.ops import tonemap as jax_tonemap

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused, testing
from libultrahdr_tpu_torch.jpeg.tables import (STD_CHROMA_QUANT,
                                               STD_LUMA_QUANT, ZIGZAG_ORDER,
                                               scaled_quant_table)
from libultrahdr_tpu_torch.ops import colors, gainmap, pixel

from test_torch_jax_native import guard_jax_native
from test_torch_ops import _exact_ratio

guard_jax_native()

CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt
# name -> (w, h, map scale, 3-channel map)
CONFIGS = {"default_128x96": (128, 96, 1, True),
           "default_256x128": (256, 128, 1, True),
           "benchmark_256x128": (256, 128, 4, False)}
USE_BASE_CG = fused._use_base_cg(CG.DISPLAY_P3, CG.BT2100,
                                 port.JpegR(device="cpu").write_xmp)


def _max_boost(ct):
    return colors.reference_display_peak_nits(ct) / colors.SDR_WHITE_NITS


# ---------------------------------------------------------------------------
# (a) the fold in the compiled HLO

def _hlo_tree(max_boost: float, gamma: float):
    """The optimized HLO of the JAX encode_gain with constant boosts and
    gamma (as the fused programs inline it) as a tree from its u8 convert
    down: (opcode, operands...), a constant as its float32 value, an op
    outside the arithmetic as its opcode."""
    fn = jax.jit(lambda s, h: jax_gainmap.encode_gain(
        s, h, jnp.float32(1.0), jnp.float32(max_boost), jnp.float32(gamma)))
    x = jnp.ones((1, 8, 8), jnp.float32)
    ops = {}
    for m in re.finditer(r"%(\S+) = (\S+) (\w+)\(([^)]*)\)",
                         fn.lower(x, x).compile().as_text()):
        name, shape, op, args = m.groups()
        ops[name] = (shape, op, [a.strip().lstrip("%")
                                 for a in args.split(",") if a.strip()])

    def tree(name):
        _, op, args = ops[name]
        if op == "constant":
            return np.float32(args[0])
        if op == "broadcast":
            return tree(args[0])
        if op in ("convert", "clamp", "multiply", "power", "log"):
            return (op, *(tree(a) for a in args))
        return op

    root, = [n for n, (shape, op, _) in ops.items()
             if op == "convert" and shape.startswith("u8")]
    return tree(root)


@pytest.mark.parametrize("gamma", [1.0, 2.0, 3.0, 0.5])
@pytest.mark.parametrize("ct", [CT.HLG, CT.PQ], ids=["HLG", "PQ"])
def test_folded_form_is_the_compiled_hlo(ct, gamma):
    mb = _max_boost(ct)
    c = gainmap.folded_gain_scale(mb, gamma)
    log = ("log", ("clamp", 1.0, "select", np.float32(mb)))
    x = ("multiply", log, c)
    if gamma == 2.0:
        x = ("multiply", ("multiply", x, x), 255.0)
    elif gamma == 3.0:
        x = ("multiply", ("multiply", x, ("multiply", x, x)), 255.0)
    elif gamma != 1.0:
        x = ("multiply", ("power", x, np.float32(gamma)), 255.0)
    want = ("convert", ("clamp", 0.0, x, 255.0))
    got = _hlo_tree(mb, gamma)
    assert got == want, (got, want)
    if (ct, gamma) == (CT.HLG, 1.0):
        assert c == np.float32("159.919785")
    # the same codes on seeded nits, every clipped sample's among them
    rs = np.random.RandomState(int(gamma * 10) + int(ct))
    sdr = (rs.rand(3, 64, 64) * 203).astype(np.float32)
    hdr = sdr * (rs.rand(3, 64, 64) * 1.2 * mb).astype(np.float32)
    want = np.asarray(jax.jit(lambda s, h: jax_gainmap.encode_gain(
        s, h, jnp.float32(1.0), jnp.float32(mb),
        jnp.float32(gamma)))(sdr, hdr))
    got = gainmap.encode_gain_folded(torch.from_numpy(sdr),
                                     torch.from_numpy(hdr), mb,
                                     gamma).numpy()
    clipped = hdr / sdr >= np.float32(mb)
    assert clipped.sum() > 1000
    np.testing.assert_array_equal(got[clipped], want[clipped])
    assert np.unique(want[clipped]).tolist() == [
        254 if (ct, gamma) == (CT.HLG, 1.0) else 255]
    _assert_u8_close(got, want)


# ---------------------------------------------------------------------------
# (b) the fused route's map against the jitted stages

def _assert_u8_close(got, want, share=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1
    assert (d > 0).mean() <= share, (d > 0).sum()


@functools.partial(jax.jit, static_argnames=("ct", "scale", "multichannel"))
def _jax_stages(y, uv, *, ct, scale, multichannel):
    """The API-0 P010 pixel stages as the JAX fused program composes them
    (``fused.py`` ``_api0_p010_block_buffers``): (y8, u8, v8, map)."""
    h, w = y.shape
    hdr = jax_pixel.unpack_p010(y, uv, jax_types.ColorRange.FULL, h, w)
    y8, u8, v8 = jax_tonemap.tonemap_to_yuv(
        hdr, jax_types.ImgFmt.P010, jax_types.ColorGamut.BT2100, ct,
        out_yuv420=True)
    sdr = jax_pixel.unpack_yuv8(y8, u8, v8, 2, 2, h, w)
    max_boost = jax_colors.reference_display_peak_nits(ct) \
        / jax_colors.SDR_WHITE_NITS
    gm = jax_gainmap.generate_gainmap_onepass(
        sdr, hdr, sdr_fmt=jax_types.ImgFmt.YUV420,
        hdr_fmt=jax_types.ImgFmt.P010,
        sdr_cg=jax_types.ColorGamut.DISPLAY_P3,
        hdr_cg=jax_types.ColorGamut.BT2100, ct=ct, scale=scale,
        multichannel=multichannel, gamma=1.0, use_luminance=False,
        sdr_is_601=False, use_base_cg=USE_BASE_CG, max_boost=max_boost)
    return y8, u8, v8, gm


def _photo(w, h, seed):
    img = testing.photo_p010(w, h, seed=seed)
    return [np.asarray(p, np.uint16) for p in img.planes[:2]]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def _port_map(y, uv, planes, ct, scale, multichannel, folded=True):
    """The port's one-pass map of the fused route (or, unfolded, the
    general path's) on the P010 planes and the given SDR u8 planes."""
    h, w = y.shape
    hdr = pixel.unpack_p010(_t(y), _t(uv), port.ColorRange.FULL, h, w)
    sdr = pixel.unpack_yuv8(*(torch.from_numpy(np.array(p))
                              for p in planes), 2, 2, h, w)
    if folded:
        return fused._onepass_gainmap(
            sdr, hdr, sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010, cg=CG.BT2100,
            ct=ct, scale=scale, multichannel=multichannel, gamma=1.0,
            use_base_cg=USE_BASE_CG).numpy()
    return gainmap.generate_gainmap_onepass(
        sdr, hdr, sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010,
        sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100, ct=ct, scale=scale,
        multichannel=multichannel, gamma=1.0, use_luminance=False,
        sdr_is_601=False, use_base_cg=USE_BASE_CG,
        max_boost=_max_boost(ct)).numpy()


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("ct", [CT.HLG, CT.PQ], ids=["HLG", "PQ"])
def test_fused_map_matches_jitted_jax(ct, cfg, seed):
    w, h, scale, mc = CONFIGS[cfg]
    y, uv = _photo(w, h, seed)
    kw = dict(ct=jax_types.ColorTransfer(int(ct)), scale=scale,
              multichannel=mc)
    *planes, jitted = (np.asarray(a) for a in _jax_stages(y, uv, **kw))
    got = _port_map(y, uv, planes, ct, scale, mc)
    if ct == CT.HLG:
        _assert_u8_close(got, jitted)
        return
    with jax.disable_jit():
        *planes, unjitted = (np.asarray(a) for a in _jax_stages(y, uv, **kw))
    _assert_u8_close(got, jitted, max(1e-3, (unjitted != jitted).mean()))
    # before the fold, the port's float pipeline follows un-jitted JAX
    _assert_u8_close(_port_map(y, uv, planes, ct, scale, mc, folded=False),
                     unjitted)


# ---------------------------------------------------------------------------
# (c) F3: the encode's scans against the JAX file's

def _tie_or_equal(cj, cp, xj, xp, q):
    """Coefficients of one component equal, but within 1 where x/q lies
    within 1e-3 of a rounding tie, or in a block whose inputs differ."""
    bh, bw = cj.shape[:2]
    same = (xj == xp).reshape(bh, 8, bw, 8).all(axis=(1, 3))
    ratio = _exact_ratio(xj, q).reshape(bh, bw, 64)[..., ZIGZAG_ORDER]
    near_tie = np.abs(np.abs(ratio - np.round(ratio)) - 0.5) < 1e-3
    assert not ((cj != cp) & ~near_tie & same[..., None]).any()
    assert np.abs(cj.astype(np.int32) - cp).max() <= 1


@pytest.mark.parametrize("seed", [4, 6])
def test_f3_encode_scans_match_jax_file(seed):
    w, h = 128, 96
    img = testing.photo_p010(w, h, seed=seed)
    jax_file = jax_jpegr.JpegR().encode_api0(jax_types.RawImage(
        int(img.fmt), int(img.cg), int(img.ct), int(img.range), w, h,
        [np.asarray(p) for p in img.planes]), 95)
    port_file = port.JpegR(device="cpu").encode_api0(img, 95)
    y, uv = _photo(w, h, seed)
    *jplanes, jmap = (np.asarray(a) for a in _jax_stages(
        y, uv, ct=jax_types.ColorTransfer.HLG, scale=1, multichannel=True))
    *pplanes, pmap = (a.numpy() for a in fused.api0_p010_pixels(
        _t(y), _t(uv), cg=CG.BT2100, ct=CT.HLG, rng=port.ColorRange.FULL,
        scale=1, multichannel=True, gamma=1.0, use_base_cg=USE_BASE_CG))
    assert (jmap == 254).sum() > 100          # the photo clips
    ycc_j = [np.asarray(p) for p in jax_fused._rgb_to_ycbcr(jnp.asarray(jmap))]
    ycc_p = [p.numpy() for p in fused._rgb_to_ycbcr(torch.from_numpy(pmap))]
    scans = [(fused._SAMPLING_420, jplanes, pplanes),
             (fused._SAMPLING_444, ycc_j, ycc_p)]
    for i, (sampling, xj, xp) in enumerate(scans):
        layout = fused._layout_for(h, w, sampling)
        for c, (cj, cp) in enumerate(zip(
                testing.decode_scan_coeffs(
                    testing.read_jpegr(jax_file)[i], layout),
                testing.decode_scan_coeffs(
                    testing.read_jpegr(port_file)[i], layout))):
            q = scaled_quant_table(STD_CHROMA_QUANT if c else STD_LUMA_QUANT,
                                   95)
            _tie_or_equal(cj, cp, xj[c], xp[c], q)


# ---------------------------------------------------------------------------
# (d) the general path stays unfolded

@pytest.mark.parametrize("seed", [4, 6])
def test_general_path_map_writes_255_like_jax(seed):
    img = testing.photo_p010(128, 96, seed=seed)
    pjr = port.JpegR(device="cpu", preset=port.EncPreset.REALTIME)
    sdr = pjr.tone_map(img)
    got, _ = pjr.generate_gainmap(sdr, img, use_luminance=False)
    want, _ = jax_jpegr.JpegR(
        preset=jax_types.EncPreset.REALTIME).generate_gainmap(
        *(jax_types.RawImage(int(i.fmt), int(i.cg), int(i.ct), int(i.range),
                             i.w, i.h, [np.asarray(p) for p in i.planes])
          for i in (sdr, img)), use_luminance=False)
    got = np.stack([np.asarray(p) for p in got.planes])
    want = np.stack([np.asarray(p) for p in want.planes])
    assert (want == 255).sum() > 1000
    np.testing.assert_array_equal(got[want == 255], 255)
    _assert_u8_close(got, want)
