"""PyTorch port: the throughput-mode API-0 P010 encode
(``fused.encode_api0_p010_pipelined``) on the CPU.

- Its files equal the port's single-image ``JpegR.encode_api0`` of each
  image byte for byte, in input order, for 1, 3 and 5 images with images of
  another size, transfer, gamut and range among them, in both
  configurations of the main path (library default: map scale 1, 3-channel
  map; reference benchmark: scale 4, 1 channel).
- Held against the JAX package's ``fused.encode_api0_p010_pipelined`` on the
  same seeded inputs: the quantised coefficients are equal except at
  rounding ties (x/q within 1e-3 of .5, tests/test_torch_ops.py), so each
  scan whose coefficients agree is byte-equal to the JAX scan, the JAX
  decoder reads every port file within 60 dB PSNR of its decode of the JAX
  file (as in tests/test_torch_encode.py), and with the JAX files' own
  coefficients fed in place of the port's float stages the pipeline gives
  the JAX files byte for byte.

On the card the same function runs the images on CUDA streams with a thread
pool of drains; ``chip_smoke.py`` holds those files against the single-image
encode on the card.
"""

import functools

import numpy as np
import pytest
import torch

import benchmarks
from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu.types import ColorTransfer as JaxTransfer
from libultrahdr_tpu.types import ImgFmt as JaxFmt

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing

CONFIGS = {
    "default": {},
    "benchmark": {"map_dimension_scale_factor": 4,
                  "use_multi_channel_gainmap": False},
}
EXIF = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x00"


def _odd_one(seed):
    """An image unlike the others: another size, PQ, Display-P3, limited
    range."""
    img = testing.photo_p010(64, 64, seed=seed)
    img.ct, img.cg = port.ColorTransfer.PQ, port.ColorGamut.DISPLAY_P3
    img.range = port.ColorRange.LIMITED
    return img


def _images(n):
    imgs = [testing.photo_p010(128, 64, seed=s) for s in range(n)]
    if n > 1:
        imgs[n // 2] = _odd_one(n)
    return imgs


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_pipelined_equals_single_image_encodes(cfg, n):
    imgs = _images(n)
    exif = EXIF if n == 3 else None
    outs = port_fused.encode_api0_p010_pipelined(
        port.JpegR(device="cpu", **CONFIGS[cfg]), imgs, 95, exif)
    assert len(outs) == n
    for img, data in zip(imgs, outs):
        want = port.JpegR(device="cpu", **CONFIGS[cfg]).encode_api0(
            img, 95, exif)
        assert data == want
    if n > 1:
        assert outs[n // 2] != outs[0]


def test_pipelined_refuses_other_formats():
    rgb = testing.photo_rgba1010102(64, 64)
    with pytest.raises(port.UhdrError) as e:
        port_fused.encode_api0_p010_pipelined(port.JpegR(device="cpu"),
                                              [testing.photo_p010(64, 64),
                                               rgb])
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM


SIZES = ((128, 64), (96, 64))


@functools.lru_cache(maxsize=None)
def _jax_files():
    """The JAX pipelined encode of the seeded photo_p010 images (library
    default configuration)."""
    jr = jax_jpegr.JpegR()
    return tuple(jax_fused.encode_api0_p010_pipelined(
        jr, [benchmarks.photo_p010(w, h) for w, h in SIZES], 95))


def _layouts(w, h):
    return [port_fused._layout_for(h, w, port_fused._SAMPLING_420),
            port_fused._layout_for(h, w, port_fused._SAMPLING_444)]


def _jax_decode(data):
    out, _, _ = jax_jpegr.JpegR().decode(data, JaxTransfer.HLG,
                                         JaxFmt.RGBA1010102)
    packed = np.asarray(out.planes[0]).astype(np.int64)
    return np.stack([(packed >> s) & 1023 for s in (0, 10, 20)])


def test_pipelined_holds_against_jax_pipelined():
    """Tolerance: coefficients equal except at rounding ties (at most 1
    apart, on at most 1e-3 of them); a scan whose coefficients all agree is
    byte-equal; the JAX decoder's HLG decode of the port file is within 60
    dB PSNR of its decode of the JAX file."""
    jax_files = _jax_files()
    outs = port_fused.encode_api0_p010_pipelined(
        port.JpegR(device="cpu"),
        [testing.photo_p010(w, h) for w, h in SIZES], 95)
    for (w, h), got, want in zip(SIZES, outs, jax_files):
        for part, layout in enumerate(_layouts(w, h)):
            g_jpeg = testing.read_jpegr(got)[part]
            w_jpeg = testing.read_jpegr(want)[part]
            gc = testing.decode_scan_coeffs(g_jpeg, layout)
            wc = testing.decode_scan_coeffs(w_jpeg, layout)
            diff = np.concatenate([np.abs(a.astype(np.int32) - b).ravel()
                                   for a, b in zip(gc, wc)])
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            if not diff.any():
                assert testing.scan_data(g_jpeg) == testing.scan_data(w_jpeg)
        ref, dec = _jax_decode(want), _jax_decode(got)
        assert dec.shape == ref.shape == (3, h, w)
        mse = np.mean((dec - ref).astype(np.float64) ** 2)
        assert mse == 0 or 10 * np.log10(1023.0 ** 2 / mse) >= 60.0


def test_pipeline_on_jax_coefficients_gives_jax_files(monkeypatch):
    """The pipeline with the JAX files' quantised coefficients in place of
    the port's float stages (its block buffers) gives the JAX pipelined
    files byte for byte: dispatch order, the pack, the drain's join and the
    container are the JAX package's."""
    jax_files = _jax_files()
    coeffs = []
    for (w, h), data in zip(SIZES, jax_files):
        coeffs.append([
            ([torch.from_numpy(c) for c in testing.decode_scan_coeffs(
                testing.read_jpegr(data)[part], layout)], layout)
            for part, layout in enumerate(_layouts(w, h))])
    calls = iter(coeffs)
    monkeypatch.setattr(port_fused, "_api0_p010_block_buffers",
                        lambda *a, **k: next(calls))
    outs = port_fused.encode_api0_p010_pipelined(
        port.JpegR(device="cpu"),
        [testing.photo_p010(w, h) for w, h in SIZES], 95)
    assert tuple(outs) == jax_files
