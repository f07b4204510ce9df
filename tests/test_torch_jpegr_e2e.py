"""PyTorch port: the cases of ``tests/test_jpegr_e2e.py`` on the port, on
the CPU (``device="cpu"``).

Encode APIs 0-4 -> container -> decode, as the reference's round trips
(tests/jpegr_test.cpp): encode, probe (``is_uhdr_image``), decode to SRGB,
HLG, PQ and LINEAR, single- and multi-channel gain maps, the REALTIME and
BEST_QUALITY presets, the compressed SDR of ``jpeg.JpegEncoder`` (imported
from the subpackage, as the JAX file does), and the metadata through the
container.  The decoded LINEAR output of a scale-1, q98 encode must stay
within 15% mean relative error of the HDR's own display-linear light
(``ops.tonemap.hdr_to_linear_rgb`` at the HLG peak), the JAX file's gate.
"""

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                         ColorTransfer, CompressedImage,
                                         EncPreset, ImgFmt, RawImage)

W, H = 160, 96
CPU = torch.device("cpu")


def _jr(**kw) -> JpegR:
    return JpegR(device="cpu", **kw)


def _jpeg_encoder():
    from libultrahdr_tpu_torch.jpeg import JpegEncoder
    return JpegEncoder(CPU)


def make_p010(w=W, h=H, seed=0):
    """Smooth HDR-ish P010 (limited range)."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // 16 + 2, w // 16 + 2))
    try:
        from PIL import Image
        y = np.array(Image.fromarray((small * 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR)).astype(np.float64) / 255.0
    except ImportError:
        y = np.broadcast_to(small.mean(), (h, w))
    y10 = (64 + y * 876).astype(np.uint16) << 6
    uv = np.full((h // 2, w), 512 << 6, np.uint16)
    uv[:, 0::2] = ((64 + 448 + (y[::2, ::2] - 0.5) * 200) * 1
                   ).astype(np.uint16) << 6
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.LIMITED, w, h,
                    [np.ascontiguousarray(y10), np.ascontiguousarray(uv)])


def make_rgba1010102(w=W, h=H, seed=1):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1024, (h, w), dtype=np.uint32)
    g = rng.integers(0, 1024, (h, w), dtype=np.uint32)
    b = rng.integers(0, 1024, (h, w), dtype=np.uint32)
    packed = r | (g << 10) | (b << 20) | np.uint32(0x3 << 30)
    return RawImage(ImgFmt.RGBA1010102, ColorGamut.BT2100, ColorTransfer.PQ,
                    ColorRange.FULL, w, h, [packed])


def make_yuv420_sdr(w=W, h=H, seed=2):
    rng = np.random.default_rng(seed)
    y = (rng.random((h, w)) * 200 + 20).astype(np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    v = np.full((h // 2, w // 2), 128, np.uint8)
    return RawImage(ImgFmt.YUV420, ColorGamut.DISPLAY_P3, ColorTransfer.SRGB,
                    ColorRange.FULL, w, h, [y, u, v])


class TestEncodeApi0:
    @pytest.mark.parametrize("multichannel", [True, False])
    def test_p010_hlg(self, multichannel):
        jr = _jr(use_multi_channel_gainmap=multichannel,
                 map_dimension_scale_factor=4)
        data = jr.encode_api0(make_p010(), quality=90)
        assert data[:2] == b"\xFF\xD8" and data[-2:] == b"\xFF\xD9"
        assert is_uhdr_image(data)
        info = jr.get_info(data)
        assert info["width"] == W and info["height"] == H
        assert info["gainmap"] is not None
        assert info["gainmap"].width == W // 4

    def test_rgba1010102_pq(self):
        jr = _jr(map_dimension_scale_factor=2)
        data = jr.encode_api0(make_rgba1010102(), quality=90)
        assert is_uhdr_image(data)

    def test_decode_all_outputs(self):
        jr = _jr(map_dimension_scale_factor=4)
        data = jr.encode_api0(make_p010(), quality=92)
        for ct, fmt, dtype, shape in [
                (ColorTransfer.HLG, ImgFmt.RGBA1010102, np.uint32, (H, W)),
                (ColorTransfer.PQ, ImgFmt.RGBA1010102, np.uint32, (H, W)),
                (ColorTransfer.LINEAR, ImgFmt.RGBAF16, np.uint16, (H, W, 4))]:
            dest, md, _ = jr.decode(data, output_ct=ct, output_fmt=fmt)
            assert dest.planes[0].dtype == dtype
            assert dest.planes[0].shape == shape
            assert md.hdr_capacity_max > 1.0
        dest, _, _ = jr.decode(data, output_ct=ColorTransfer.SRGB,
                               output_fmt=ImgFmt.RGBA8888)
        assert dest.planes[0].shape == (H, W)
        assert dest.planes[0].dtype == np.uint32

    def test_decode_reconstruction_quality(self):
        """Decoded linear output must approximate the HDR's display-linear
        light computed without JPEG in the loop (the PSNR gate analog)."""
        from libultrahdr_tpu_torch.ops import pixel
        from libultrahdr_tpu_torch.ops.tonemap import hdr_to_linear_rgb

        hdr = make_p010()
        jr = _jr(map_dimension_scale_factor=1)
        data = jr.encode_api0(hdr, quality=98)
        dest, md, _ = jr.decode(data, output_ct=ColorTransfer.LINEAR,
                                output_fmt=ImgFmt.RGBAF16)
        got = dest.planes[0][..., :3].view(np.float16).astype(np.float64)
        # ground truth: unpack hdr -> linear display RGB in SDR-white units
        rgb = hdr_to_linear_rgb(pixel.unpack(hdr, CPU), ImgFmt.P010,
                                ColorGamut.BT2100, ColorTransfer.HLG)
        # HLG: scene->display with peak 1000 nits, normalize to SDR white
        truth = np.moveaxis(rgb.numpy(), 0, -1) * (1000.0 / 203.0)
        err = np.abs(got - truth)
        rel = err.mean() / max(truth.mean(), 1e-6)
        assert rel < 0.15, f"mean relative error {rel}"


class TestEncodeApi1to4:
    def test_api1_yuv420_sdr(self):
        jr = _jr(map_dimension_scale_factor=4, preset=EncPreset.BEST_QUALITY)
        data = jr.encode_api1(make_p010(), make_yuv420_sdr(), quality=90)
        assert is_uhdr_image(data)
        dest, md, gm = jr.decode(data, output_ct=ColorTransfer.HLG,
                                 return_gainmap=True)
        assert gm is not None

    def test_api1_realtime_preset(self):
        jr = _jr(map_dimension_scale_factor=4, preset=EncPreset.REALTIME)
        data = jr.encode_api1(make_p010(), make_yuv420_sdr(), quality=90)
        assert is_uhdr_image(data)

    def test_api2(self):
        sdr = make_yuv420_sdr()
        sdr_jpeg = _jpeg_encoder().compress(sdr, 90)
        jr = _jr(map_dimension_scale_factor=4)
        data = jr.encode_api2(make_p010(), sdr,
                              CompressedImage(sdr_jpeg, ColorGamut.DISPLAY_P3))
        assert is_uhdr_image(data)

    def test_api3(self):
        sdr = make_yuv420_sdr()
        sdr_jpeg = _jpeg_encoder().compress(sdr, 90)
        jr = _jr(map_dimension_scale_factor=4)
        data = jr.encode_api3(make_p010(),
                              CompressedImage(sdr_jpeg, ColorGamut.DISPLAY_P3))
        assert is_uhdr_image(data)

    def test_api4_passthrough(self):
        jr = _jr(map_dimension_scale_factor=4)
        hdr = make_p010()
        sdr = jr.tone_map(hdr)
        gm_img, md = jr.generate_gainmap(sdr, hdr, use_luminance=False)
        gm_jpeg = jr.compress_gainmap(gm_img)
        sdr_jpeg = _jpeg_encoder().compress(sdr, 90)
        data = jr.encode_api4(CompressedImage(sdr_jpeg, ColorGamut.DISPLAY_P3),
                              CompressedImage(gm_jpeg), md)
        assert is_uhdr_image(data)
        dest, md2, _ = jr.decode(data, output_ct=ColorTransfer.HLG)
        assert md2.use_base_cg == md.use_base_cg

    def test_not_uhdr_image(self):
        plain = _jpeg_encoder().compress(make_yuv420_sdr(), 90)
        assert not is_uhdr_image(plain)


class TestMetadataRoundTrip:
    def test_metadata_survives_container(self):
        jr = _jr(map_dimension_scale_factor=4, preset=EncPreset.BEST_QUALITY,
                 use_multi_channel_gainmap=True)
        hdr = make_p010()
        sdr = jr.tone_map(hdr)
        gm_img, md = jr.generate_gainmap(sdr, hdr, use_luminance=False)
        data = jr.encode_api1(hdr, sdr, quality=90)
        _, md2, _ = jr.decode(data, output_ct=ColorTransfer.HLG)
        assert md2.hdr_capacity_max == pytest.approx(1000 / 203.0, rel=1e-4)
        assert md2.hdr_capacity_min == pytest.approx(1.0, rel=1e-4)
