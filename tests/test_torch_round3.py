"""PyTorch port: the cases of ``tests/test_round3_fixes.py`` on the port.

- The XMP reader (``container/xmp.py``, the port's copy): a real XML
  tokenizer feeding the reference's XMPXmlHandler state machine
  (jpegrutils.cpp:109-433); hostile markup (comments, CDATA, single
  quotes, entities, element-style values, attributes outside
  rdf:Description), the float prefix parse of ``stringstream >> float``,
  and the Apple namespace, each with the JAX file's outcome and message.
- ``enable_gpu_acceleration(False)`` on ``UhdrDecoder(device="cpu")`` /
  ``UhdrEncoder(device="cpu")``: the general path, within 1 code of the
  fused route's decode; the host engine (``UHDR_TPU_DECODE_ENGINE=host``,
  the JAX package's ``auto``) within the cross-engine contract (>= 55 dB a
  channel, at most 8 codes) of the general path; the general encode a
  valid JPEG_R.
- A fractional map scale keeps float gains end to end (gainmapmath.cpp:
  871-921): ``ops.apply.apply_gainmap_core`` on a u8 gain equals it on the
  same gain as float; the float-factor IDW output differs from its u8
  re-quantization once applied; ``JpegR.apply_gainmap`` at a fractional
  scale gives an RGBA1010102 image of the SDR's size.
"""

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch import api
from libultrahdr_tpu_torch.container import xmp
from libultrahdr_tpu_torch.errors import UhdrError, UhdrErrorCode
from libultrahdr_tpu_torch.jpegr import JpegR, is_uhdr_image
from libultrahdr_tpu_torch.ops import apply as apply_ops, idw
from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                         ColorTransfer, EncPreset,
                                         GainMapMetadata, ImgFmt, RawImage)


def _wrap(xml_body: bytes) -> bytes:
    return xmp.XMP_NAMESPACE.encode() + b"\x00" + xml_body


def _valid_desc(extra: bytes = b"") -> bytes:
    return _wrap(b'<rdf:Description hdrgm:Version="1.0" '
                 b'hdrgm:GainMapMax="2" hdrgm:HDRCapacityMax="2"'
                 + extra + b"/>")


class TestXmpTokenizer:
    """The reader is a real XML tokenizer feeding the XMPXmlHandler state
    machine (jpegrutils.cpp:109-433), not a regex scrape — hostile markup
    tokenizes the way image_io's XmlReader does."""

    def test_plain_attributes(self):
        md = xmp.parse_xmp_metadata(_valid_desc())
        assert md.max_content_boost[0] == pytest.approx(4.0)
        assert md.hdr_capacity_max == pytest.approx(4.0)
        # defaults (jpegrutils.cpp:793-860)
        assert md.min_content_boost[0] == pytest.approx(1.0)
        assert md.offset_sdr[0] == pytest.approx(1.0 / 64.0)

    def test_attrs_inside_comment_ignored(self):
        payload = _wrap(
            b'<rdf:RDF><!-- <rdf:Description hdrgm:Version="1.0" '
            b'hdrgm:GainMapMax="9" hdrgm:HDRCapacityMax="9"/> -->'
            b'<rdf:Description hdrgm:Version="1.0" hdrgm:GainMapMax="1" '
            b'hdrgm:HDRCapacityMax="1"/></rdf:RDF>')
        md = xmp.parse_xmp_metadata(payload)
        assert md.max_content_boost[0] == pytest.approx(2.0)

    def test_attrs_inside_cdata_ignored(self):
        payload = _wrap(
            b'<rdf:Description hdrgm:Version="1.0" hdrgm:GainMapMax="1" '
            b'hdrgm:HDRCapacityMax="1"><![CDATA[ <rdf:Description '
            b'hdrgm:GainMapMax="9"/> ]]></rdf:Description>')
        md = xmp.parse_xmp_metadata(payload)
        assert md.max_content_boost[0] == pytest.approx(2.0)

    def test_single_quoted_attributes(self):
        payload = _wrap(b"<rdf:Description hdrgm:Version='1.0' "
                        b"hdrgm:GainMapMax='3' hdrgm:HDRCapacityMax='3'/>")
        md = xmp.parse_xmp_metadata(payload)
        assert md.max_content_boost[0] == pytest.approx(8.0)

    def test_malformed_xml_is_parser_error(self):
        for body in (b"<a><b></a>", b"<a foo=bar/>", b"<a", b"<a><!-- x</a>",
                     b'<a b="1/>'):
            with pytest.raises(UhdrError) as ei:
                xmp.parse_xmp_metadata(_wrap(body))
            assert ei.value.code == UhdrErrorCode.UHDR_CODEC_UNKNOWN_ERROR

    def test_float_prefix_parse_like_istream(self):
        # stringstream >> float takes the valid prefix (jpegrutils.cpp:260)
        payload = _wrap(b'<rdf:Description hdrgm:Version="1.0" '
                        b'hdrgm:GainMapMax="2.5e0junk" '
                        b'hdrgm:HDRCapacityMax="2.5"/>')
        md = xmp.parse_xmp_metadata(payload)
        assert md.max_content_boost[0] == pytest.approx(2.0 ** 2.5)

    def test_unparseable_required_reports_not_found(self):
        payload = _wrap(b'<rdf:Description hdrgm:Version="1.0" '
                        b'hdrgm:GainMapMax="zzz" hdrgm:HDRCapacityMax="1"/>')
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "could not find attribute hdrgm:GainMapMax" in str(ei.value)

    def test_unparseable_optional_is_parse_error(self):
        payload = _valid_desc(b' hdrgm:Gamma="abc"')
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "unable to parse attribute hdrgm:Gamma" in str(ei.value)

    def test_base_rendition_garbage_is_parse_error(self):
        payload = _valid_desc(b' hdrgm:BaseRenditionIsHDR="maybe"')
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "BaseRenditionIsHDR" in str(ei.value)

    def test_base_rendition_true_rejected(self):
        payload = _valid_desc(b' hdrgm:BaseRenditionIsHDR="True"')
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "base rendition" in str(ei.value)

    def test_element_style_hdrgm_not_supported(self):
        # the reference's XMPXmlHandler only reads hdrgm values from
        # attributes (AttributeName/AttributeValue, jpegrutils.cpp:176-252);
        # element-content style must NOT parse
        payload = _wrap(b"<rdf:Description hdrgm:Version=\"1.0\">"
                        b"<hdrgm:GainMapMax>2</hdrgm:GainMapMax>"
                        b"<hdrgm:HDRCapacityMax>2</hdrgm:HDRCapacityMax>"
                        b"</rdf:Description>")
        with pytest.raises(UhdrError):
            xmp.parse_xmp_metadata(payload)

    def test_attrs_outside_rdf_description_ignored(self):
        # state machine arms only on rdf:Description (containerName,
        # jpegrutils.cpp:435)
        payload = _wrap(b'<rdf:Other hdrgm:Version="1.0" '
                        b'hdrgm:GainMapMax="2" hdrgm:HDRCapacityMax="2"/>')
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "hdrgm:Version" in str(ei.value)

    def test_apple_element_content(self):
        payload = _wrap(
            b"<rdf:Description>"
            b"<HDRGainMap:HDRGainMapVersion>65536"
            b"</HDRGainMap:HDRGainMapVersion>"
            b"<HDRGainMap:HDRGainMapHeadroom>3.0"
            b"</HDRGainMap:HDRGainMapHeadroom>"
            b"</rdf:Description>")
        md = xmp.parse_xmp_metadata(payload)
        assert md.max_content_boost[0] == pytest.approx(8.0)
        assert md.hdr_capacity_max == pytest.approx(8.0)
        assert md.min_content_boost[0] == pytest.approx(1.0)

    def test_apple_headroom_missing_without_exif_errors(self):
        payload = _wrap(b"<rdf:Description>"
                        b"<HDRGainMapVersion>1</HDRGainMapVersion>"
                        b"</rdf:Description>")
        with pytest.raises(UhdrError) as ei:
            xmp.parse_xmp_metadata(payload)
        assert "Exif Headroom missing" in str(ei.value)

    def test_entity_decoding_in_attribute(self):
        payload = _valid_desc(b' hdrgm:Gamma="&#49;.5"')  # "1.5"
        md = xmp.parse_xmp_metadata(payload)
        assert md.gamma[0] == pytest.approx(1.5)


def _p010(w=96, h=64, seed=11):
    rs = np.random.RandomState(seed)
    y = (rs.randint(0, 1024, (h, w)).astype(np.uint16) << 6)
    uv = (rs.randint(300, 700, (h // 2, w)).astype(np.uint16) << 6)
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h, [y, uv])


class TestGpuAccelerationToggle:
    """uhdr_enable_gpu_acceleration(0) forces the general path
    (capi/ultrahdr_tpu.h contract), analogous to the reference skipping the
    GLES branch (jpegr.cpp:1507-1523)."""

    def _encode(self):
        jr = JpegR(map_dimension_scale_factor=2, preset=EncPreset.REALTIME,
                   device="cpu")
        return jr.encode_api0(_p010(), quality=92)

    def _decode_with(self, data, enable, engine=None, monkey=None):
        if engine is not None:
            monkey.setenv("UHDR_TPU_DECODE_ENGINE", engine)
        dec = api.UhdrDecoder(device="cpu")
        dec.enable_gpu_acceleration(enable)
        dec.set_image(data)
        dec.set_out_color_transfer(ColorTransfer.HLG)
        dec.set_out_img_format(ImgFmt.RGBA1010102)
        return np.asarray(dec.decode().planes[0])

    def test_decode_general_path_close_to_fused(self, monkeypatch):
        data = self._encode()
        # the fused route against the gpu-off general path: the same math
        # on other stage layouts, per-channel 10-bit values within 1 code
        a = self._decode_with(data, True, "device", monkeypatch)
        b = self._decode_with(data, False)
        for sh in (0, 10, 20):
            da = ((a >> sh) & 0x3FF).astype(np.int32)
            db = ((b >> sh) & 0x3FF).astype(np.int32)
            assert np.abs(da - db).max() <= 1

    def test_decode_host_engine_close_to_general(self, monkeypatch):
        """The native host engine (the JAX package's ``auto``, the port's
        ``host``) reproduces the general path within the cross-engine
        contract (the host engine uses the reference's LUT
        discretizations, the general path exact math on the same grids:
        >= 55 dB, small code deltas)."""
        data = self._encode()
        a = self._decode_with(data, True, "host", monkeypatch)
        b = self._decode_with(data, False)
        for sh in (0, 10, 20):
            da = ((a >> sh) & 0x3FF).astype(np.float64)
            db = ((b >> sh) & 0x3FF).astype(np.float64)
            mse = np.mean((da - db) ** 2)
            psnr = 200.0 if mse == 0 else 10 * np.log10(1023.0 ** 2 / mse)
            assert psnr >= 55.0, psnr
            assert np.abs(da - db).max() <= 8

    def test_encode_general_path_valid(self):
        enc = api.UhdrEncoder(device="cpu")
        enc.enable_gpu_acceleration(False)
        enc.set_raw_image(_p010(), api.ImgLabel.HDR)
        out = enc.encode()
        assert is_uhdr_image(out)


class TestFractionalMapScaleFloat:
    """Fractional map-scale apply keeps float gains end to end (the
    reference samples the map in float, gainmapmath.cpp:871-921: no u8
    re-quantization)."""

    def _fractional_inputs(self):
        h, w = 48, 72
        mh, mw = 19, 29  # w/mw = 2.48..., fractional
        rs = np.random.RandomState(3)
        sdr_yuv = rs.rand(3, h, w).astype(np.float32)
        gain_u8 = rs.randint(0, 256, (1, mh, mw)).astype(np.uint8)
        md = GainMapMetadata()
        md.max_content_boost[:] = 4.0
        md.min_content_boost[:] = 1.0
        md.gamma[:] = 1.0
        md.offset_sdr[:] = 1.0 / 64
        md.offset_hdr[:] = 1.0 / 64
        md.hdr_capacity_min = 1.0
        md.hdr_capacity_max = 4.0
        md.use_base_cg = True
        return h, w, sdr_yuv, gain_u8, md

    @staticmethod
    def _apply(sdr_yuv, gain, arrays, out_ct):
        return apply_ops.apply_gainmap_core(
            torch.from_numpy(sdr_yuv), torch.from_numpy(gain), arrays,
            scale_k=1, weight=np.float32(1.0), out_ct=out_ct,
            sdr_cg=ColorGamut.DISPLAY_P3, hdr_cg=ColorGamut.BT2100,
            use_base_cg=True).numpy()

    def test_float_gain_passthrough_matches_u8(self):
        h, w, sdr_yuv, gain_u8, md = self._fractional_inputs()
        arrays = apply_ops.metadata_to_arrays(md)
        full = np.ascontiguousarray(
            np.repeat(np.repeat(gain_u8, 4, axis=1), 4, axis=2)[:, :h, :w])
        out_u8 = self._apply(sdr_yuv, full, arrays, ColorTransfer.HLG)
        out_f = self._apply(sdr_yuv, full.astype(np.float32) / 255.0, arrays,
                            ColorTransfer.HLG)
        np.testing.assert_array_equal(out_u8, out_f)

    def test_fractional_apply_runs_and_differs_from_requantized(self):
        h, w, sdr_yuv, gain_u8, md = self._fractional_inputs()
        arrays = apply_ops.metadata_to_arrays(md)
        scale = w / gain_u8.shape[2]
        gain_f = torch.clamp(idw.idw_upsample_fractional(
            torch.from_numpy(gain_u8).to(torch.float32) / 255.0, scale, h,
            w), 0.0, 1.0).numpy()
        out_float = self._apply(sdr_yuv, gain_f, arrays, ColorTransfer.LINEAR)
        gain_req = np.clip(np.round(gain_f * 255.0), 0, 255).astype(np.uint8)
        out_req = self._apply(sdr_yuv, gain_req, arrays, ColorTransfer.LINEAR)
        # the float path is the contract; re-quantization would perturb the
        # outputs
        assert out_float.shape[:2] == (h, w)
        assert (out_float != out_req).any()

    def test_jpegr_apply_gainmap_fractional_e2e(self):
        h, w, sdr_yuv, gain_u8, md = self._fractional_inputs()
        yuv8 = np.clip(sdr_yuv * 255, 0, 255).astype(np.uint8)
        sdr = RawImage(ImgFmt.YUV444, ColorGamut.DISPLAY_P3,
                       ColorTransfer.SRGB, ColorRange.FULL, w, h,
                       [yuv8[0], yuv8[1], yuv8[2]])
        jr = JpegR(device="cpu")
        dest = jr.apply_gainmap(sdr, gain_u8, ColorGamut.BT2100, md,
                                ColorTransfer.HLG, ImgFmt.RGBA1010102,
                                max_display_boost=4.0)
        assert dest.w == w and dest.h == h
        assert dest.planes[0].dtype == np.uint32
