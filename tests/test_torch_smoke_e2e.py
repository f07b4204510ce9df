"""PyTorch port: the case of ``tests/test_smoke_e2e.py`` on the port, on
the CPU: one API-0 encode, its container metadata parsed back, one HDR and
one SDR decode of a 48x32 ramp, crossing every layer (pixels -> gain map
-> JPEG -> container -> parse -> decode -> apply); the ramp must stay a
ramp in both outputs.
"""

import numpy as np

from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                         ColorTransfer, ImgFmt, RawImage)

W, H = 48, 32


def _hdr():
    rs = np.random.RandomState(2)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    lum = 300 + 500 * (xx / W) + rs.rand(H, W) * 20
    y = (np.clip(lum, 0, 1023).astype(np.uint16) << 6)
    uv = (rs.randint(400, 600, (H // 2, W)).astype(np.uint16) << 6)
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, W, H, [y, uv])


def test_smoke_encode_decode_roundtrip():
    jr = JpegR(map_dimension_scale_factor=2,
               use_multi_channel_gainmap=False, device="cpu")
    blob = jr.encode_api0(_hdr(), quality=92)
    assert blob[:2] == b"\xff\xd8" and is_uhdr_image(blob)

    info = jr.get_info(blob)
    assert (info["width"], info["height"]) == (W, H)
    assert info["gainmap"] is not None
    assert info["gainmap"].width == W // 2

    # the metadata survives the container well enough to gate on
    md = jr.parse_gainmap_metadata(info["gainmap"].iso,
                                   info["gainmap"].xmp,
                                   info["primary"].exif)
    assert float(md.max_content_boost[0]) > 1.0
    assert md.hdr_capacity_max >= md.hdr_capacity_min

    hdr_out, md2, _ = jr.decode(blob, output_ct=ColorTransfer.HLG)
    assert hdr_out.fmt == ImgFmt.RGBA1010102
    assert hdr_out.planes[0].shape == (H, W)
    # the ramp scene must stay a ramp through the whole pipeline
    red = (np.asarray(hdr_out.planes[0]) & 0x3FF).astype(np.int64)
    assert red[:, -4:].mean() > red[:, :4].mean() + 50

    sdr_out, _, _ = jr.decode(blob, output_ct=ColorTransfer.SRGB,
                              output_fmt=ImgFmt.RGBA8888)
    assert sdr_out.fmt == ImgFmt.RGBA8888
    red8 = (np.asarray(sdr_out.planes[0]) & 0xFF).astype(np.int64)
    assert red8[:, -4:].mean() > red8[:, :4].mean() + 20
