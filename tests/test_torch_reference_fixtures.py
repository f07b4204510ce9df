"""PyTorch port: the cases of ``tests/test_reference_fixtures.py`` on the
port, on the CPU (``device="cpu"``).

They read the reference repository's own test data (JPEG and raw
fixtures) from ``/root/reference/tests/data``, the files the reference's
gtests use (tests/jpegr_test.cpp:1440-1481 Apple interop with exact
expected headrooms, :46-47 raw fixture sizes), at the JAX file's
tolerances.  Skipped, as the JAX file is, where that checkout is absent;
they run wherever it is mounted."""

import os

import numpy as np
import pytest
import torch

DATA = "/root/reference/tests/data"

pytestmark = pytest.mark.skipif(not os.path.isdir(DATA),
                                reason="reference fixtures not available")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


class TestAppleInterop:
    """decodeApple parity (jpegr_test.cpp:1440-1481): gain map metadata
    derived from Apple's XMP + EXIF MakerNote must match exactly."""

    @pytest.mark.parametrize("name,headroom,gm_dims", [
        ("apple_gainmap_old.jpg", 8.0, (256, 192)),
        ("apple_gainmap_new.jpg", 23.1474762, (256, 192)),
    ])
    def test_headroom(self, name, headroom, gm_dims):
        from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
        data = _read(name)
        assert is_uhdr_image(data)
        jr = JpegR(device="cpu")
        primary, gm = jr.extract_primary_and_gainmap(data)
        assert gm is not None
        from libultrahdr_tpu_torch.jpeg import parse_jpeg
        pinfo = parse_jpeg(primary, parse_only=True)
        gm_info = parse_jpeg(gm, parse_only=True)
        md = jr.parse_gainmap_metadata(gm_info.iso, gm_info.xmp, pinfo.exif)
        assert float(md.hdr_capacity_max) == pytest.approx(headroom,
                                                           rel=1e-6)
        assert float(md.max_content_boost[0]) == pytest.approx(headroom,
                                                               rel=1e-6)
        assert (gm_info.height, gm_info.width) == gm_dims

    def test_apple_decode_runs(self):
        from libultrahdr_tpu_torch.jpegr import JpegR
        from libultrahdr_tpu_torch.types import ColorTransfer
        data = _read("apple_gainmap_new.jpg")
        dest, md, gm = JpegR(device="cpu").decode(
            data, output_ct=ColorTransfer.HLG, return_gainmap=True)
        assert dest.w > 0 and dest.h > 0
        assert gm is not None


class TestJpegFixtures:
    """Decoder parity on the minnie fixture family
    (jpegdecoderhelper_test.cpp coverage)."""

    @pytest.mark.parametrize("name,w,h,ncomp", [
        ("minnie-320x240-yuv.jpg", 320, 240, 3),
        ("minnie-320x240-y.jpg", 320, 240, 1),
        ("minnie-320x240-rgb.jpg", 320, 240, 3),
        ("jpeg_image.jpg", 1280, 720, 3),
    ])
    def test_parse_and_decode(self, name, w, h, ncomp):
        from libultrahdr_tpu_torch.jpeg import (decode_to_planes,
                                                 decode_to_rgba, parse_jpeg)
        data = _read(name)
        info = parse_jpeg(data)
        assert (info.width, info.height) == (w, h)
        assert info.num_components == ncomp
        planes, fmt = decode_to_planes(data, info, device="cpu")
        assert planes[0].shape[0] >= h and planes[0].shape[1] >= w
        packed = decode_to_rgba(data, info, device="cpu")
        assert packed.shape == (h, w)

    def test_progressive_fixture_decodes(self):
        """minnie-320x240-yuv-icc.jpg is a progressive JPEG with an ICC
        profile; the progressive path (jdphuff analog) must match libjpeg
        within the baseline tolerance."""
        import io
        from PIL import Image
        from libultrahdr_tpu_torch.jpeg import decode_to_rgba, parse_jpeg
        data = _read("minnie-320x240-yuv-icc.jpg")
        info = parse_jpeg(data, parse_only=True)
        assert info.progressive and info.icc is not None
        assert (info.width, info.height) == (320, 240)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                         ).astype(int)
        packed = decode_to_rgba(data, device="cpu")
        ours = np.stack([(packed >> 0) & 0xFF, (packed >> 8) & 0xFF,
                         (packed >> 16) & 0xFF], -1).astype(int)
        diff = np.abs(ours - pil)
        assert diff.max() <= 4 and diff.mean() < 0.5

    def test_decode_vs_libjpeg_pixels(self):
        """Our float IDCT + fancy-upsample decode vs libjpeg (via PIL):
        must agree within a few codes (libjpeg ISLOW is an integer DCT
        approximation; the combined tolerance covers both rounders)."""
        import io
        from PIL import Image
        from libultrahdr_tpu_torch.jpeg import decode_to_rgba
        data = _read("minnie-320x240-yuv.jpg")
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")
                         ).astype(int)
        packed = decode_to_rgba(data, device="cpu")
        ours = np.stack([(packed >> 0) & 0xFF, (packed >> 8) & 0xFF,
                         (packed >> 16) & 0xFF], -1).astype(int)
        diff = np.abs(ours - pil)
        assert diff.max() <= 4 and diff.mean() < 0.5

    def test_encode_vs_libjpeg_decode(self):
        """Round-trip: our encoder's output decoded by libjpeg (PIL) vs the
        source — bounds the whole encode stack against a third-party
        decoder."""
        import io
        from PIL import Image
        from libultrahdr_tpu_torch.jpeg import JpegEncoder
        from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                                 ColorTransfer, ImgFmt,
                                                 RawImage)
        w, h = 320, 240
        raw = np.frombuffer(_read("minnie-320x240.yu12"), np.uint8)
        y = raw[:w * h].reshape(h, w)
        u = raw[w * h: w * h * 5 // 4].reshape(h // 2, w // 2)
        v = raw[w * h * 5 // 4:].reshape(h // 2, w // 2)
        img = RawImage(ImgFmt.YUV420, ColorGamut.BT709, ColorTransfer.SRGB,
                       ColorRange.FULL, w, h, [y, u, v])
        data = JpegEncoder(torch.device("cpu")).compress(img, 93)
        dec = np.asarray(Image.open(io.BytesIO(data)).convert("YCbCr"))
        diff = np.abs(dec[..., 0].astype(int) - y.astype(int))
        assert diff.mean() < 3.0  # q93 luma loss bound


class TestRawFixtureEncode:
    """E2E on the reference's raw fixtures (jpegr_test.cpp:46-47)."""

    def test_p010_encode_decode(self):
        from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
        from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                                 ColorTransfer, ImgFmt,
                                                 RawImage)
        w, h = 1280, 720
        raw = np.frombuffer(_read("raw_p010_image.p010"), np.uint8)
        y = raw[:w * h * 2].view(np.uint16).reshape(h, w)
        uv = raw[w * h * 2: w * h * 3].view(np.uint16).reshape(h // 2, w)
        img = RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                       ColorRange.LIMITED, w, h, [y, uv])
        jr = JpegR(map_dimension_scale_factor=4,
                   use_multi_channel_gainmap=False, preset=0, device="cpu")
        data = jr.encode_api0(img, quality=90)
        assert is_uhdr_image(data)
        dest, md, _ = JpegR(device="cpu").decode(
            data, output_ct=ColorTransfer.HLG)
        assert (dest.w, dest.h) == (w, h)

    def test_yuv420_api1(self):
        from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
        from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                                 ColorTransfer, ImgFmt,
                                                 RawImage)
        w, h = 1280, 720
        raw = np.frombuffer(_read("raw_p010_image.p010"), np.uint8)
        y = raw[:w * h * 2].view(np.uint16).reshape(h, w)
        uv = raw[w * h * 2: w * h * 3].view(np.uint16).reshape(h // 2, w)
        hdr = RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                       ColorRange.LIMITED, w, h, [y, uv])
        raw2 = np.frombuffer(_read("raw_yuv420_image.yuv420"), np.uint8)
        sy = raw2[:w * h].reshape(h, w)
        su = raw2[w * h: w * h * 5 // 4].reshape(h // 2, w // 2)
        sv = raw2[w * h * 5 // 4: w * h * 3 // 2].reshape(h // 2, w // 2)
        sdr = RawImage(ImgFmt.YUV420, ColorGamut.BT709, ColorTransfer.SRGB,
                       ColorRange.FULL, w, h, [sy, su, sv])
        jr = JpegR(map_dimension_scale_factor=4,
                   use_multi_channel_gainmap=True, device="cpu")
        data = jr.encode_api1(hdr, sdr, quality=90)
        assert is_uhdr_image(data)
