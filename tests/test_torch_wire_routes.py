"""PyTorch port: every route over every wire knob value, on the CPU.

The routes of ``tests/test_wire_codec.py`` that the port runs behind the
JAX package's knobs, at small sizes: each file is byte for byte the port's
raw route's (UHDR_TPU_WIRE unset), each decode output the raw decode's,
and each route names the wire it rode (``wire.RODE``):

- the API-0 P010 encode with UHDR_TPU_WIRE = auto, vw, each fixed rung, an
  unparsable value, and on the dense 10-bit fallback;
- RGBA1010102 / RGBAF16 on the channel wires (vw, the rungs, a noisy
  channel on a wider rung, raw for a varying alpha or noise);
- API-1 P010 + YUV420 with UHDR_TPU_WIRE_API1 = auto, vw, hNsM, raw, both
  presets, and noise that overflows every rung;
- the decode over the coefficient wire (UHDR_TPU_WIRE) and the download
  wire (UHDR_TPU_WIRE_DOWN = auto, 4, 8, raw), HLG and LINEAR, through
  ``JpegR.decode`` and ``UhdrDecoder``, and the JAX package's decode of the
  same file (on its own wires) within ``testing.check_decoded_close``;
- ``decode_to_device_batch`` over the coefficient wire, a stream of
  another wire kind taking the per-image route as in JAX;
- the pipelined encode with UHDR_TPU_WIRE set, each image over its own
  wire, files equal to the single-image encodes.
"""

import functools

import numpy as np
import pytest
import torch

from libultrahdr_tpu import jpegr as jax_jpegr

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused, testing, wire
from libultrahdr_tpu_torch.jpegr import JpegR

W, H = 256, 128
Fmt, CT = port.ImgFmt, port.ColorTransfer
KNOBS = ("UHDR_TPU_WIRE", "UHDR_TPU_WIRE_API1", "UHDR_TPU_WIRE_DOWN")
CONFIGS = {"benchmark": dict(map_dimension_scale_factor=4,
                             use_multi_channel_gainmap=False),
           "default": {}}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    wire.RODE.clear()
    wire._DOWN_STICKY.clear()


def _jr(cfg="benchmark", **kw):
    return JpegR(device="cpu", **CONFIGS[cfg], **kw)


def _raw_image(fmt, planes, ct=CT.HLG):
    return port.RawImage(fmt, port.ColorGamut.BT2100, ct,
                         port.ColorRange.FULL, W, H, planes)


def _smooth_plane(h, w, seed=0, edges=True):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v = 400 + 250 * np.sin(xx / 37.0) + 150 * np.cos(yy / 23.0)
    v += rs.rand(h, w) * 24
    if edges:
        v[:, w // 3:] += 400
        v[h // 2:, :] -= 300
    return (np.clip(v, 0, 1023).astype(np.uint16) << 6)


@functools.lru_cache(maxsize=None)
def _raw_file(cfg: str, seed: int = 11) -> bytes:
    return _jr(cfg).encode_api0(testing.photo_p010(W, H, seed=seed), 95)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("value,rode", [
    ("auto", "p010:vw"), ("vw", "p010:vw"), ("2d5", "p010:2d5"),
    ("1d7", "p010:1d7"), ("2d2", "p010:2d2"), ("garbage", "p010:1d7")])
def test_p010_encode_over_each_wire(monkeypatch, cfg, value, rode):
    """test_fused_encode_identical_across_wire_modes and
    test_vw_encode_byte_identical_to_ladder: the file is the raw route's
    whichever wire carried the input."""
    raw = _raw_file(cfg)
    monkeypatch.setenv("UHDR_TPU_WIRE", value)
    assert _jr(cfg).encode_api0(testing.photo_p010(W, H), 95) == raw
    assert dict(wire.RODE) == {rode: 1}


def test_p010_encode_dense_fallback(monkeypatch):
    """test_fused_encode_identical_across_wire_paths: with the delta rung
    refused, the dense 10-bit pack carries the same file."""
    raw = _raw_file("benchmark")
    monkeypatch.setenv("UHDR_TPU_WIRE", "1d7")
    monkeypatch.setattr(wire, "pack_delta7_wire", lambda *a, **k: None)
    assert _jr().encode_api0(testing.photo_p010(W, H), 95) == raw
    assert dict(wire.RODE) == {"p010:10bit": 1}


def _rgb_images():
    rs = np.random.RandomState(40)
    base = _smooth_plane(H, W, seed=40) >> 6
    g = np.clip(base + rs.randint(-3, 4, base.shape), 0, 1023)
    smooth = (base.astype(np.uint32) | (g.astype(np.uint32) << 10)
              | (np.clip(1023 - base, 0, 1023).astype(np.uint32) << 20)
              | np.uint32(0x3) << 30)
    vals = (_smooth_plane(H, W, seed=41) >> 6).astype(np.float32) / 1023.0
    comp = np.empty((H, W, 4), np.float16)
    comp[..., 0] = vals.astype(np.float16)
    comp[..., 1] = (vals * 0.5).astype(np.float16)
    comp[..., 2] = (1.0 - vals).astype(np.float16)
    comp[..., 3] = np.float16(1.0)
    noisy = np.clip(base.astype(np.int64) + rs.randint(-120, 121, base.shape),
                    0, 1023).astype(np.uint32)
    mixed = (base.astype(np.uint32) | (noisy << 10)
             | ((1023 - base).astype(np.uint32) << 20) | np.uint32(0x3) << 30)
    noise = (rs.randint(0, 1 << 30, (H, W)).astype(np.uint32)
             | np.uint32(0x3) << 30)
    alpha = smooth.copy()
    alpha[0, 0] &= np.uint32(0x3FFFFFFF)
    return {"1010102": (Fmt.RGBA1010102, smooth, "rgb:vw,vw,vw"),
            "f16": (Fmt.RGBAF16, comp, None),
            "noisy channel": (Fmt.RGBA1010102, mixed, "rgb:vw,vw,vw"),
            "noise": (Fmt.RGBA1010102, noise, "rgb:vw,vw,vw"),
            "varying alpha": (Fmt.RGBA1010102, alpha, "rgb:raw")}


@pytest.mark.parametrize("name", list(_rgb_images()))
def test_rgb_encode_over_the_channel_wires(monkeypatch, name):
    """test_rgb_wire_byte_invisible, _v2_mixed_rungs,
    _varying_alpha_falls_back, _ladder_fallback_on_sharp_content and
    _vw_wire_byte_invisible_noisy_channels: the file is the raw upload's;
    an f16 channel that vw refuses rides the rung JAX's ladder picks."""
    fmt, plane, rode = _rgb_images()[name]
    img = _raw_image(fmt, [np.ascontiguousarray(plane)],
                     CT.LINEAR if fmt == Fmt.RGBAF16 else CT.HLG)
    raw = _jr().encode_api0(img, 92)
    monkeypatch.setenv("UHDR_TPU_WIRE", "auto")
    assert _jr().encode_api0(img, 92) == raw
    if rode is None:
        chans, _ = wire._split_rgb_channels(plane.view(np.uint16), fmt)
        want = []
        for ch in chans:
            bits = 0 if wire.pack_vw_chan(ch) is not None else next(
                b for b in wire._RGB_LADDERS[fmt]
                if wire.pack_rgb_chan(ch, b) is not None)
            want.append("vw" if bits == 0 else f"2d{bits}")
        rode = "rgb:" + ",".join(want)
    assert dict(wire.RODE) == {rode: 1}


@functools.lru_cache(maxsize=None)
def _api1_inputs(noise=False):
    if noise:
        rs = np.random.RandomState(9)
        y = (rs.randint(0, 1024, (H, W)).astype(np.uint16) << 6)
        uv = (rs.randint(0, 1024, (H // 2, W)).astype(np.uint16) << 6)
    else:
        y, uv = _smooth_plane(H, W, seed=60), _smooth_plane(H // 2, W, 61)
    hdr = _raw_image(Fmt.P010, [y, uv])
    return hdr, _jr().tone_map(hdr)


@pytest.mark.parametrize("preset", [port.EncPreset.REALTIME,
                                    port.EncPreset.BEST_QUALITY])
@pytest.mark.parametrize("value,noise", [
    ("auto", False), ("vw", False), ("h4s3", False), ("h6s6", False),
    ("raw", False), ("garbage", False), ("auto", True), ("h5s4", True)])
def test_api1_encode_over_each_wire(monkeypatch, preset, value, noise):
    """test_api1_wire_byte_invisible and test_api1_wire_overflow_falls_back:
    the file is the raw five-plane upload's, whichever wire (or raw after
    an overflow) carried the planes."""
    hdr, sdr = _api1_inputs(noise)
    jr = _jr(preset=preset)
    raw = jr.encode_api1(hdr, sdr, 92)
    assert dict(wire.RODE) == {}
    monkeypatch.setenv("UHDR_TPU_WIRE_API1", value)
    assert jr.encode_api1(hdr, sdr, 92) == raw
    took, = wire.RODE
    if value in ("auto", "vw"):
        assert took == "api1:vw"
    elif value == "raw" or noise:
        assert took == "api1:raw"
    else:
        ladder = wire._api1_wire_ladder()
        fit = next((f"api1:h{hb}s{sb}" for hb, sb in ladder
                    if wire.pack_api1_wire(hdr.planes[0], hdr.planes[1],
                                           sdr.planes[:3], hb, sb)
                    is not None), "api1:raw")
        assert took == fit


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("ct", [CT.HLG, CT.LINEAR])
def test_decode_over_the_wires(monkeypatch, cfg, ct):
    """test_decode_down_wire_value_invisible and
    test_decode_linear_down_wire_value_invisible, and the coefficient wire:
    every knob value's output equals the raw decode's."""
    data = _raw_file(cfg)
    jr = _jr(cfg)
    raw = jr.decode(data, output_ct=ct)[0].planes[0]
    assert dict(wire.RODE) == {}
    for env in ({"UHDR_TPU_WIRE": "auto"}, {"UHDR_TPU_WIRE_DOWN": "auto"},
                {"UHDR_TPU_WIRE_DOWN": "4"}, {"UHDR_TPU_WIRE_DOWN": "8"},
                {"UHDR_TPU_WIRE_DOWN": "raw"},
                {"UHDR_TPU_WIRE": "vw", "UHDR_TPU_WIRE_DOWN": "auto"}):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        wire.RODE.clear()
        wire._DOWN_STICKY.clear()
        got = jr.decode(data, output_ct=ct)[0].planes[0]
        np.testing.assert_array_equal(got, raw, str(env))
        routes = {k.split(":")[0] for k in wire.RODE}
        assert routes == {r for k, r in (("UHDR_TPU_WIRE", "coeff"),
                                         ("UHDR_TPU_WIRE_DOWN", "down"))
                          if k in env}, (env, dict(wire.RODE))


def test_uhdr_decoder_and_jax_decode_agree(monkeypatch):
    """Through UhdrDecoder with every knob set, the output is the raw
    decode's; the JAX package's decode of the same file, on its own
    coefficient and download wires, is within the decode contract."""
    data = _raw_file("benchmark")
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(CT.HLG)
    dec.set_out_img_format(Fmt.RGBA1010102)
    raw = dec.decode().planes[0]
    for k in ("UHDR_TPU_WIRE", "UHDR_TPU_WIRE_DOWN"):
        monkeypatch.setenv(k, "auto")
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(CT.HLG)
    dec.set_out_img_format(Fmt.RGBA1010102)
    got = dec.decode().planes[0]
    np.testing.assert_array_equal(got, raw)
    assert {k.split(":")[0] for k in wire.RODE} == {"coeff", "down"}
    jax_out = jax_jpegr.JpegR().decode(data, output_ct=CT.HLG)[0].planes[0]
    testing.check_decoded_close(got, np.asarray(jax_out), CT.HLG)


def test_batch_decode_over_the_coefficient_wire(monkeypatch):
    """decode_to_device_batch with UHDR_TPU_WIRE set equals the raw batch;
    a stream whose wire kind differs from the group's first takes the
    per-image route, as the JAX package's batch drops it."""
    files = [_raw_file("benchmark", s) for s in (11, 12)]
    flat = _jr().encode_api0(_raw_image(Fmt.P010, [
        np.full((H, W), 512 << 6, np.uint16),
        np.full((H // 2, W), 512 << 6, np.uint16)]), 95)
    files.insert(1, flat)
    jr = _jr()
    raw = jr.decode_to_device_batch(files, CT.HLG)
    monkeypatch.setenv("UHDR_TPU_WIRE", "auto")
    kinds = []
    for data in files:
        primary, pinfo, gm_jpeg, gm_info, *_ = jr._parse_jpegr(data)
        planes = fused.decode_coefficients(primary, pinfo)[0] \
            + fused.decode_coefficients(gm_jpeg, gm_info)[0]
        kinds.append(wire.pack_coeff_wire_best(planes)[1])
    per_image = []
    orig = JpegR._decode_to_device_one

    def spy(self, data, *a, **k):
        per_image.append(files.index(data))
        return orig(self, data, *a, **k)
    monkeypatch.setattr(JpegR, "_decode_to_device_one", spy)
    got = jr.decode_to_device_batch(files, CT.HLG)
    for (a, _), (b, _) in zip(got, raw):
        assert torch.equal(a, b)
    assert per_image == [i for i, k in enumerate(kinds) if k != kinds[0]]
    assert kinds[1] != kinds[0]


def test_pipelined_encode_over_wire(monkeypatch):
    """test_batched_pipeline_matches_single on the port: with UHDR_TPU_WIRE
    set the pipelined encode sends each image over its own wire (images of
    two sizes, a delta rung, and the 10-bit fallback) and writes the
    single-image encodes' files."""
    imgs = [testing.photo_p010(W, H, seed=s) for s in range(3)] + [
        testing.photo_p010(130, 66, seed=9)]
    jr = _jr()
    singles = [jr.encode_api0(im, 92) for im in imgs]
    for value in ("auto", "1d7"):
        monkeypatch.setenv("UHDR_TPU_WIRE", value)
        wire.RODE.clear()
        assert fused.encode_api0_p010_pipelined(jr, imgs, 92) == singles
        assert sum(wire.RODE.values()) == len(imgs)
        assert all(k.startswith("p010:") and k != "p010:10bit"
                   for k in wire.RODE)
    monkeypatch.setattr(wire, "pack_vw_wire", lambda *a: (None, None))
    monkeypatch.setenv("UHDR_TPU_WIRE", "vw")          # -> the 10-bit pack
    wire.RODE.clear()
    assert fused.encode_api0_p010_pipelined(jr, imgs[:2], 92) == singles[:2]
    assert dict(wire.RODE) == {"p010:10bit": 2}
