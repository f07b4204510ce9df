"""PyTorch port: the XMP-metadata cases of
``tests/test_decode_device_and_xmp.py`` on the port, on the CPU.

The Adobe hdrgm XMP metadata mode (the reference's UHDR_WRITE_XMP; its
Android build writes XMP in place of ISO, Android.bp:37-38): an XMP-only
file from the general path and from the fused route decodes with the
boosts the encoder wrote, and a file with both kinds carries both in the
gain-map JPEG.  The file's two ``decode_to_device`` cases are held by
``tests/test_torch_decode.py``
(``test_decode_to_device_and_jpegr_decode_agree`` and
``test_unsupported_decode_shapes_raise``), against the JAX package.
"""

import numpy as np
import pytest

from libultrahdr_tpu_torch.container import segments
from libultrahdr_tpu_torch.jpeg import parse_jpeg
from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                         ColorTransfer, EncPreset, ImgFmt,
                                         RawImage)


def _p010(w=96, h=64):
    rs = np.random.RandomState(6)
    y = (rs.randint(0, 1024, (h, w)).astype(np.uint16) << 6)
    uv = (rs.randint(300, 700, (h // 2, w)).astype(np.uint16) << 6)
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h, [y, uv])


def _xmp_only() -> JpegR:
    return JpegR(map_dimension_scale_factor=2,
                 use_multi_channel_gainmap=False,
                 preset=EncPreset.REALTIME, write_iso=False, write_xmp=True,
                 device="cpu")


def _gainmap_info(data: bytes):
    r = segments.scan_jpeg_images(data, limit=2)
    return parse_jpeg(data[r[1][0]:r[1][1]], parse_only=True)


class TestXmpMode:
    def test_xmp_roundtrip(self):
        data = _xmp_only().encode_api0(_p010(), quality=92, use_fused=False)
        assert is_uhdr_image(data)
        info = _gainmap_info(data)
        assert info.iso is None and info.xmp is not None
        dest, md, _ = JpegR(device="cpu").decode(data,
                                                 output_ct=ColorTransfer.HLG)
        assert md.hdr_capacity_max == pytest.approx(1000.0 / 203.0, rel=1e-4)
        assert md.min_content_boost[0] == pytest.approx(1.0)
        assert dest.w == 96 and dest.h == 64

    def test_xmp_mode_fused(self):
        fused = _xmp_only().encode_api0(_p010(), quality=92)
        assert is_uhdr_image(fused)
        assert _gainmap_info(fused).iso is None
        _, md, _ = JpegR(device="cpu").decode(fused,
                                              output_ct=ColorTransfer.HLG)
        assert md.hdr_capacity_max == pytest.approx(1000.0 / 203.0, rel=1e-4)

    def test_both_metadata_modes(self):
        jr = JpegR(map_dimension_scale_factor=2, write_iso=True,
                   write_xmp=True, preset=EncPreset.REALTIME, device="cpu")
        data = jr.encode_api0(_p010(), quality=92, use_fused=False)
        gm_info = _gainmap_info(data)
        assert gm_info.iso is not None and gm_info.xmp is not None
