"""PyTorch port: the SMPTE 2094-50 gain map (``agtm``) against the JAX
package.

- ``pchip_coefficients``, ``pchip_eval`` and ``_rule_lut`` (host numpy,
  copied) equal the JAX functions bit for bit, and refuse bad knots with
  the same error code.
- ``generate_gainmap_agtm(device="cpu")`` on P010, RGBA1010102 and YUV420
  inputs (``testing``'s photographic twins at 96x56), with one rule, two
  rules (one mixing RGB with max and min), a capacity between two rules,
  and the baseline only: the metadata equal exactly; the RGB888 u8 map
  within 1 of the JAX map on at most 1e-3 of the samples (the repo's u8
  contract: XLA's CPU fusion contracts products and sums into FMAs, eager
  PyTorch does not).
- JAX ``tests/test_agtm.py``'s checks, on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libultrahdr_tpu import agtm as jax_agtm
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.errors import UhdrError as JaxUhdrError

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import agtm
from libultrahdr_tpu_torch import testing

W, H = 96, 56
Fmt = port.ImgFmt

CURVES = [
    ([0.0, 1.0], [0.0, 1.0]),
    ([0.0, 0.3, 0.7, 1.0], [0.0, 1.0, 1.5, 2.0]),
    ([0.0, 0.2, 0.5, 1.0], [0.0, 0.1, 1.4, 2.0]),
    ([0.1, 0.4, 0.45, 0.9], [2.0, -0.5, 0.7, 0.6]),       # sign changes
    ([0.0, 0.1, 0.2, 0.9, 1.0], [0.0, 3.0, 0.2, 0.1, 2.5]),
    ([0.2, 0.8], [1.0, 3.0]),
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_pchip_matches_jax_bit_exact(curve):
    x, y = (np.array(v) for v in CURVES[curve])
    np.testing.assert_array_equal(agtm.pchip_coefficients(x, y),
                                  jax_agtm.pchip_coefficients(x, y))
    q = np.linspace(-0.2, 1.2, 2001)
    np.testing.assert_array_equal(agtm.pchip_eval(x, y, q),
                                  jax_agtm.pchip_eval(x, y, q))
    mix = agtm.ComponentMix(component=1.0)
    rule = list(zip(x, y))
    got = agtm._rule_lut(agtm.GainCurveRule(1.0, mix, rule))
    want = jax_agtm._rule_lut(jax_agtm.GainCurveRule(
        1.0, jax_agtm.ComponentMix(component=1.0), rule))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x", [[0.5, 0.5], [0.5], [0.0, 0.6, 0.4]])
def test_pchip_refuses_bad_knots_as_jax(x):
    y = np.arange(len(x), dtype=np.float64)
    with pytest.raises(port.UhdrError) as e:
        agtm.pchip_coefficients(np.array(x), y)
    with pytest.raises(JaxUhdrError) as je:
        jax_agtm.pchip_coefficients(np.array(x), y)
    assert int(e.value.code) == int(je.value.code)


def _image(fmt):
    if fmt == "P010":
        return testing.photo_p010(W, H)
    if fmt == "RGBA1010102":
        return testing.photo_rgba1010102(W, H)
    return port.JpegR(device="cpu").tone_map(testing.photo_p010(W, H))


def _to_jax(img):
    return jax_types.RawImage(int(img.fmt), int(img.cg), int(img.ct),
                              int(img.range), img.w, img.h,
                              [np.asarray(p) for p in img.planes])


def _rules(mod, name):
    """(DynamicMetadata, hdr_capacity_max) of a case, in `mod`."""
    luma = mod.ComponentMix(component=1.0)
    rgb = mod.ComponentMix(rgb=(0.25, 0.4, 0.1), max=0.3, min=0.2)
    r1 = mod.GainCurveRule(1.0, luma, [(0.0, 0.0), (1.0, 1.0)])
    r2 = mod.GainCurveRule(3.0, rgb, [(0.0, 0.0), (0.5, 2.5), (1.0, 3.0)])
    r3 = mod.GainCurveRule(2.0, luma, [(0.0, 0.0), (0.5, 1.0), (1.0, 2.0)])
    return {"one_rule": (mod.DynamicMetadata(0.0, [r3]), -1.0),
            "two_rules": (mod.DynamicMetadata(0.0, [r2, r1]), -1.0),
            "capacity_between": (mod.DynamicMetadata(0.0, [r1, r2]), 4.0),
            "capacity_below": (mod.DynamicMetadata(0.5, [r1, r2]), 1.2),
            "baseline_only": (mod.DynamicMetadata(1.0, []), -1.0)}[name]


@pytest.mark.parametrize("case", ["one_rule", "two_rules", "capacity_between",
                                  "capacity_below", "baseline_only"])
@pytest.mark.parametrize("fmt", ["P010", "RGBA1010102", "YUV420"])
def test_generate_gainmap_agtm_matches_jax(fmt, case):
    img = _image(fmt)
    md_p, cap = _rules(agtm, case)
    md_j, _ = _rules(jax_agtm, case)
    gm, md = agtm.generate_gainmap_agtm(img, md_p, cap, device="cpu")
    jgm, jmd = jax_agtm.generate_gainmap_agtm(_to_jax(img), md_j, cap)
    for f in dataclasses.fields(md):
        np.testing.assert_array_equal(getattr(md, f.name),
                                      getattr(jmd, f.name))
    assert (gm.fmt, gm.w, gm.h) == (Fmt.RGB888, W, H)
    assert (int(gm.cg), int(gm.ct), int(gm.range)) == \
        (int(jgm.cg), int(jgm.ct), int(jgm.range))
    a, b = gm.planes[0], np.asarray(jgm.planes[0])
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (H, W, 3)
    diff = np.abs(a.astype(np.int32) - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# ---- JAX tests/test_agtm.py, on the port --------------------------------

def test_pchip_interpolates_knots_and_keeps_monotone():
    x = np.array([0.0, 0.3, 0.7, 1.0])
    y = np.array([0.0, 1.0, 1.5, 2.0])
    np.testing.assert_allclose(agtm.pchip_eval(x, y, x), y, atol=1e-12)
    x = np.array([0.0, 0.2, 0.5, 1.0])
    y = np.array([0.0, 0.1, 1.4, 2.0])
    out = agtm.pchip_eval(x, y, np.linspace(0, 1, 1001))
    assert np.all(np.diff(out) >= -1e-9)
    out = agtm.pchip_eval(np.array([0.2, 0.8]), np.array([1.0, 3.0]),
                          np.array([0.0, 1.0]))
    np.testing.assert_allclose(out, [1.0, 3.0])


def test_generates_rgb888_map():
    img = testing.photo_p010(64, 32)
    md_in, _ = _rules(agtm, "one_rule")
    gm, md = agtm.generate_gainmap_agtm(img, md_in, device="cpu")
    assert gm.fmt == Fmt.RGB888 and (gm.w, gm.h) == (img.w, img.h)
    assert md.hdr_capacity_max == pytest.approx(4.0)
    assert md.min_content_boost[0] == 1.0
    p = gm.planes[0]
    assert p.shape == (img.h, img.w, 3)
    # one log gain for all three channels (agtm.cpp:190-194)
    assert np.array_equal(p[..., 0], p[..., 1])


def test_capacity_interpolation_and_baseline():
    img = testing.photo_p010(64, 32)
    md_in, _ = _rules(agtm, "capacity_between")
    mid, md = agtm.generate_gainmap_agtm(img, md_in, hdr_capacity_max=4.0,
                                         device="cpu")
    assert md.hdr_capacity_max == 4.0
    lo, _ = agtm.generate_gainmap_agtm(img, md_in, hdr_capacity_max=2.0,
                                       device="cpu")
    assert not np.array_equal(mid.planes[0], lo.planes[0])
    base, _ = agtm.generate_gainmap_agtm(
        img, agtm.DynamicMetadata(1.0, []), device="cpu")
    assert int(base.planes[0].max()) == 0


def test_defaults_to_the_card(monkeypatch):
    """generate_gainmap_agtm runs on the card unless asked for the CPU: with
    no GPU the default raises, and nothing runs elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    md_in, _ = _rules(agtm, "one_rule")
    with pytest.raises(port.UhdrError) as e:
        agtm.generate_gainmap_agtm(testing.photo_p010(16, 16), md_in)
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
