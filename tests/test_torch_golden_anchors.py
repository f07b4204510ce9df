"""PyTorch port: the colour primitives of ``ops/colors`` against published
values, the cases of ``tests/test_golden_anchors.py``.

The port's curves take float32 tensors (here on the CPU); they are pinned
to independently published constants (BT.2100-2 and BT.2408 tables, the
sRGB specification, well-known reference points) at the reference's 1e-4
tolerance (tests/gainmapmath_test.cpp:26), as the JAX package's are.
"""

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch.ops import colors
from libultrahdr_tpu_torch.types import ColorGamut, ColorTransfer

A = 1e-4


def _f(fn, x):
    return float(fn(torch.tensor(x, dtype=torch.float32)))


class TestPQ:
    def test_1000_nits(self):
        # PQ(1000/10000) = 0.751827 (BT.2408-7 Table 2)
        assert _f(colors.pq_oetf, 0.1) == pytest.approx(0.751827, abs=A)

    def test_sdr_reference_white(self):
        # PQ(203/10000) = 0.5806 ("58% PQ" graphics white, BT.2408)
        assert _f(colors.pq_oetf, 0.0203) == pytest.approx(0.580688, abs=A)

    def test_black_and_peak(self):
        assert _f(colors.pq_oetf, 0.0) == 0.0
        assert _f(colors.pq_oetf, 1.0) == pytest.approx(1.0, abs=A)

    def test_inverse_round_trip(self):
        for v in (0.01, 0.0203, 0.1, 0.5, 1.0):
            assert _f(colors.pq_inv_oetf, _f(colors.pq_oetf, v)) == \
                pytest.approx(v, abs=A)


class TestHLG:
    def test_knee_point(self):
        # HLG OETF(1/12) = 0.5 exactly (BT.2100-2 Table 5)
        assert _f(colors.hlg_oetf, 1.0 / 12.0) == pytest.approx(0.5, abs=A)

    def test_peak(self):
        assert _f(colors.hlg_oetf, 1.0) == pytest.approx(1.0, abs=A)

    def test_sqrt_segment(self):
        # below the knee: sqrt(3E)
        assert _f(colors.hlg_oetf, 0.01) == pytest.approx(
            np.sqrt(0.03), abs=A)

    def test_inverse(self):
        assert _f(colors.hlg_inv_oetf, 0.5) == pytest.approx(1.0 / 12.0,
                                                             abs=A)


class TestSRGB:
    def test_18_percent_gray(self):
        # sRGB OETF(0.18) = 0.46136 (the classic mid-gray anchor)
        assert _f(colors.srgb_oetf, 0.18) == pytest.approx(0.461356, abs=A)

    def test_linear_segment(self):
        # below 0.0031308: 12.92 * x
        assert _f(colors.srgb_oetf, 0.002) == pytest.approx(0.02584, abs=A)

    def test_inverse_mid(self):
        assert _f(colors.srgb_inv_oetf, 0.5) == pytest.approx(0.214041,
                                                              abs=A)
        assert _f(colors.srgb_inv_oetf, 0.04045) == pytest.approx(
            0.04045 / 12.92, abs=A)


class TestNitsAnchors:
    def test_reference_peaks(self):
        assert colors.SDR_WHITE_NITS == 203.0
        assert colors.HLG_MAX_NITS == 1000.0
        assert colors.PQ_MAX_NITS == 10000.0
        assert colors.reference_display_peak_nits(ColorTransfer.HLG) == 1000.0
        assert colors.reference_display_peak_nits(ColorTransfer.PQ) == 10000.0

    def test_luminance_coefficients_sum_to_one(self):
        for cg in (ColorGamut.BT709, ColorGamut.DISPLAY_P3,
                   ColorGamut.BT2100):
            c = np.asarray(colors.luminance_coeffs_for_gamut(cg))
            assert float(c.sum()) == pytest.approx(1.0, abs=1e-5)

    def test_gamut_matrices_preserve_white(self):
        # any RGB gamut conversion must map (1,1,1) to (1,1,1)
        for m in (colors.BT709_TO_P3, colors.BT709_TO_BT2100,
                  colors.P3_TO_BT709, colors.P3_TO_BT2100,
                  colors.BT2100_TO_BT709, colors.BT2100_TO_P3):
            np.testing.assert_allclose(np.asarray(m).sum(axis=1),
                                       np.ones(3), atol=5e-5)
            white = colors.convert_gamut(torch.ones(3, 1, 1), m)
            np.testing.assert_allclose(white.flatten().numpy(), np.ones(3),
                                       atol=5e-5)

    def test_gamut_matrices_invert(self):
        pairs = [(colors.BT709_TO_P3, colors.P3_TO_BT709),
                 (colors.BT709_TO_BT2100, colors.BT2100_TO_BT709),
                 (colors.P3_TO_BT2100, colors.BT2100_TO_P3)]
        for a, b in pairs:
            np.testing.assert_allclose(np.asarray(a) @ np.asarray(b),
                                       np.eye(3), atol=2e-5)
