"""PyTorch port: the multi-image decode routes and the SRGB output on the CPU.

- ``JpegR.decode_to_device_batch`` and the microbatched ``decode_to_device``
  (the cases of tests/test_decode_fused.py's TestDecodeBatch and
  TestDecodeMicrobatcher, with the port on the CPU): every output equals the
  port's per-image route (``decode_to_device(..., microbatch=False)``) bit
  for bit, and is within ``testing.check_decoded_close`` of the JAX
  package's ``decode_to_device`` of the same stream (10-bit codes equal or
  neighbouring attainable codes, half floats within 4 ulps, on at most 5e-3
  / 1e-3 of the samples, PSNR >= 60 dB).
- The SRGB output: ``UhdrDecoder``'s RGBA8888 image and its decoded gain map
  (1 and 3 channels) equal the JAX ``UhdrDecoder``'s bytes (both are libjpeg's
  integer decode); ``is_uhdr_image`` agrees with the JAX package's.
- A batch over a mesh of CPU devices equals the batch without one; an
  argument that is no mesh raises ``invalid_param``; an empty effect queue
  gives the plain output and a descriptor that is no effect
  ``invalid_param``.

The streams are written by the JAX encoder, as in tests/test_decode_fused.py.
On the card the batch runs each image on one of the side streams;
``chip_smoke.py`` holds those outputs against the per-image route there.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu.types import (ColorGamut, ColorRange, ColorTransfer,
                                   EncPreset, ImgFmt, RawImage)

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import jpegr as port_jpegr
from libultrahdr_tpu_torch import testing

CT = {ColorTransfer.HLG: port.ColorTransfer.HLG,
      ColorTransfer.PQ: port.ColorTransfer.PQ,
      ColorTransfer.LINEAR: port.ColorTransfer.LINEAR}


@functools.lru_cache(maxsize=None)
def _enc(w, h, seed, scale=2, quality=92, uv_lo=300, uv_hi=700,
         multichannel=True):
    """A JAX-written JPEG_R of seeded noise (the inputs of
    tests/test_decode_fused.py)."""
    rs = np.random.RandomState(seed)
    y = (rs.randint(0, 1024, (h, w)).astype(np.uint16) << 6)
    uv = (rs.randint(uv_lo, uv_hi, (h // 2, w)).astype(np.uint16) << 6)
    img = RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                   ColorRange.FULL, w, h, [y, uv])
    jr = jax_jpegr.JpegR(map_dimension_scale_factor=scale,
                         use_multi_channel_gainmap=multichannel,
                         preset=EncPreset.REALTIME)
    return jr.encode_api0(img, quality=quality)


def _held(data, arr, md, ct):
    """One output of a batched route: bit for bit the port's per-image
    route, within check_decoded_close of the JAX decode_to_device."""
    one, one_md = port.JpegR(device="cpu").decode_to_device(
        data, output_ct=CT[ct], microbatch=False)
    assert arr.dtype == one.dtype and torch.equal(arr, one)
    assert md.hdr_capacity_max == one_md.hdr_capacity_max
    ref, _ = jax_jpegr.JpegR().decode_to_device(data, output_ct=ct,
                                                microbatch=False)
    testing.check_decoded_close(arr, np.asarray(ref), CT[ct], ct.name)


class TestDecodeBatch:
    """decode_to_device_batch: one group of uniform streams, the rest on
    the per-image route, outputs in input order."""

    def test_batch_matches_per_image(self):
        streams = [_enc(96, 64, s) for s in range(3)]
        outs = port.JpegR(device="cpu").decode_to_device_batch(
            streams, output_ct=port.ColorTransfer.HLG)
        assert len(outs) == 3
        for data, (arr, md) in zip(streams, outs):
            _held(data, arr, md, ColorTransfer.HLG)

    def test_mixed_shapes_fall_back(self, monkeypatch):
        streams = [_enc(96, 64, 1), _enc(128, 64, 2), _enc(96, 64, 3)]
        jr = port.JpegR(device="cpu")
        groups = []
        real = port.JpegR._decode_group

        def spy(self_, group, *a):
            groups.append(len(group))
            return real(self_, group, *a)

        monkeypatch.setattr(port.JpegR, "_decode_group", spy)
        outs = jr.decode_to_device_batch(streams,
                                         output_ct=port.ColorTransfer.PQ)
        assert groups == [2] and len(outs) == 3
        assert tuple(outs[1][0].shape) == (64, 128)
        for data, (arr, md) in zip(streams, outs):
            _held(data, arr, md, ColorTransfer.PQ)

    def test_linear_f16_batch(self):
        streams = [_enc(96, 64, s, scale=1) for s in (5, 6)]
        outs = port.JpegR(device="cpu").decode_to_device_batch(
            streams, output_ct=port.ColorTransfer.LINEAR)
        for data, (arr, md) in zip(streams, outs):
            assert arr.dtype == torch.int16 and arr.shape == (64, 96, 4)
            _held(data, arr, md, ColorTransfer.LINEAR)


class TestDecodeMicrobatcher:
    """decode_to_device's request coalescing (the default): concurrent
    callers ride one decode_to_device_batch, and every caller gets the
    per-image route's bytes."""

    @staticmethod
    def _stream(seed):
        return _enc(96, 64, seed, uv_lo=200, uv_hi=800)

    def test_concurrent_callers_coalesce(self, monkeypatch):
        streams = [self._stream(s) for s in range(4)]
        jr = port.JpegR(device="cpu")
        calls = []
        real_batch = port.JpegR.decode_to_device_batch

        def spy(self_, xs, *a, **k):
            calls.append(len(xs))
            return real_batch(self_, xs, *a, **k)

        monkeypatch.setattr(port.JpegR, "decode_to_device_batch", spy)
        ready = threading.Barrier(4)
        outs = [None] * 4

        def worker(i):
            ready.wait()
            outs[i] = jr.decode_to_device(streams[i],
                                          output_ct=port.ColorTransfer.HLG)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # the callers landed in one window: a batch dispatch of two or more
        assert calls and max(calls) >= 2, calls
        mb = jr._decode_microbatcher()
        assert mb.batches == len([c for c in calls if c >= 2])
        assert mb.retries == 0
        for data, (arr, md) in zip(streams, outs):
            _held(data, arr, md, ColorTransfer.HLG)

    def test_single_caller_still_works(self):
        data = self._stream(7)
        jr = port.JpegR(device="cpu")
        arr, md = jr.decode_to_device(data, output_ct=port.ColorTransfer.PQ)
        _held(data, arr, md, ColorTransfer.PQ)
        assert jr._decode_microbatcher().batches == 0

    @pytest.mark.parametrize("broken", ["corrupt scan", "no gain map"])
    def test_error_isolation(self, broken):
        """A broken stream next to a good one: the good caller gets its
        output.  Zeroed scan bytes (the JAX test's case) may decode to
        garbage without an error; a file without its gain map gives its
        caller its own exception, after the batch failed and both requests
        were retried alone."""
        good = self._stream(8)
        bad = good[:600] + b"\x00" * 40 + good[640:] \
            if broken == "corrupt scan" \
            else port.JpegR.extract_primary_and_gainmap(good)[0]
        jr = port.JpegR(device="cpu")
        jr._mb = port_jpegr._DeviceDecodeMicrobatcher(window_s=5.0,
                                                      max_k=2)
        res = {}
        ready = threading.Barrier(2)

        def worker(name, data):
            ready.wait()
            try:
                res[name] = jr.decode_to_device(
                    data, output_ct=port.ColorTransfer.HLG)
            except Exception as e:  # noqa: BLE001
                res[name] = e

        ts = [threading.Thread(target=worker, args=("good", good)),
              threading.Thread(target=worker, args=("bad", bad))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not isinstance(res["good"], Exception)
        _held(good, *res["good"], ColorTransfer.HLG)
        if broken == "no gain map":
            assert isinstance(res["bad"], port.UhdrError)
            assert "no gain map" in str(res["bad"])
            assert jr._mb.retries == 2 and jr._mb.batches == 0


def test_mesh_batch_and_effects():
    """A batch over a mesh (`mesh`, two CPU devices on its data axis)
    equals the batch without one and the per-image route bit for bit, and
    a mesh argument that is no ``parallel.Mesh`` raises ``invalid_param``.
    Effects on the device: an empty queue returns the plain output on both
    routes, and a descriptor that is no effect raises ``invalid_param``,
    as the JAX package's ``apply_effects_packed`` does."""
    from libultrahdr_tpu_torch import parallel
    data = _enc(96, 64, 0)
    jr = port.JpegR(device="cpu")
    streams = [_enc(96, 64, s) for s in range(4)]
    mesh = parallel.make_mesh(2, 1, [torch.device("cpu")] * 2)
    sharded = jr.decode_to_device_batch(streams, mesh=mesh)
    unsharded = jr.decode_to_device_batch(streams)
    for d, (so, smd), (uo, _) in zip(streams, sharded, unsharded):
        assert torch.equal(so, uo)
        _held(d, so, smd, ColorTransfer.HLG)
    with pytest.raises(port.UhdrError) as e:
        jr.decode_to_device_batch([data, data], mesh=object())
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
    plain, _ = jr.decode_to_device(data, microbatch=False)
    for microbatch in (True, False):
        got, _ = jr.decode_to_device(data, effects=[], microbatch=microbatch)
        assert torch.equal(got, plain)
        with pytest.raises(port.UhdrError) as e:
            jr.decode_to_device(data, effects=["mirror"],
                                microbatch=microbatch)
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM


# ---------------------------------------------------------------------------
# SRGB / RGBA8888 output


def _srgb_decode(dec, data, fmt, ct):
    """(RGBA8888 image, decoded gain map) of a UhdrDecoder, either
    package's, asked for SRGB output."""
    dec.set_image(data)
    dec.set_out_img_format(fmt.RGBA8888)
    dec.set_out_color_transfer(ct.SRGB)
    return dec.decode(), dec.get_decoded_gainmap_image()


@pytest.mark.parametrize("multichannel", [False, True])
@pytest.mark.parametrize("size", [(96, 64), (130, 66)])
def test_srgb_output_equals_jax(size, multichannel):
    """RGBA8888 bytes, the decoded gain map and its format equal the JAX
    UhdrDecoder's (exact: libjpeg's integer decode on both sides)."""
    w, h = size
    data = _enc(w, h, 4, scale=1 if multichannel else 2,
                multichannel=multichannel)
    img, gm = _srgb_decode(port.UhdrDecoder(device="cpu"), data,
                           port.ImgFmt, port.ColorTransfer)
    ref, ref_gm = _srgb_decode(jax_api.UhdrDecoder(), data, ImgFmt,
                               ColorTransfer)
    assert (img.w, img.h, int(img.fmt), int(img.ct), int(img.cg)) == \
        (ref.w, ref.h, int(ref.fmt), int(ref.ct), int(ref.cg))
    assert img.planes[0].dtype == np.uint32
    np.testing.assert_array_equal(img.planes[0], np.asarray(ref.planes[0]))
    assert (img.planes[0] >> 24 == 255).all()
    assert (gm.w, gm.h, int(gm.fmt), int(gm.cg)) == \
        (ref_gm.w, ref_gm.h, int(ref_gm.fmt), int(ref_gm.cg))
    np.testing.assert_array_equal(gm.planes[0], np.asarray(ref_gm.planes[0]))


def test_srgb_decode_without_gainmap():
    """JpegR.decode to SRGB parses no gain map unless it is returned: a
    file with its gain map cut off still decodes, as in the JAX package."""
    data = _enc(96, 64, 3)
    primary, _ = port.JpegR.extract_primary_and_gainmap(data)
    for d in (data, primary):
        dest, md, gm = port.JpegR(device="cpu").decode(
            d, port.ColorTransfer.SRGB, port.ImgFmt.RGBA8888)
        ref, ref_md, _ = jax_jpegr.JpegR().decode(d, ColorTransfer.SRGB,
                                                  ImgFmt.RGBA8888)
        assert md is None and ref_md is None and gm is None
        np.testing.assert_array_equal(dest.planes[0],
                                      np.asarray(ref.planes[0]))


def test_is_uhdr_image_agrees_with_jax():
    data = _enc(96, 64, 2)
    primary, _ = port.JpegR.extract_primary_and_gainmap(data)
    cases = {"jpeg_r": data, "plain jpeg": primary,
             "truncated": data[:len(data) // 3], "empty": b""}
    got = {k: port.is_uhdr_image(v) for k, v in cases.items()}
    assert got == {k: jax_jpegr.is_uhdr_image(v) for k, v in cases.items()}
    assert got["jpeg_r"] and not got["plain jpeg"]
