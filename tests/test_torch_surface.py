"""PyTorch port: its public surface against the JAX package's.

- Every ported module's public names, and each public function's and
  public method's parameter names, against the JAX module's: the JAX names
  must exist in the port and the JAX parameters must begin the port's
  (the port may add trailing ones, such as ``device``), less the
  exclusions named in ``EXCLUDED`` with their reasons.
- The signatures the port once broke (ROADMAP fault F1), each called the
  JAX way and compared with JAX's result: ``ops.colors.ootf(rgb, ct,
  lum_coeffs)``, ``yuv_to_rgb(..., clamp=False)``,
  ``effects_device.apply_effects_packed(arr, effects, base_w, base_h)`` and
  ``jpeg.decoder.decode_to_planes`` / ``decode_to_rgba`` with
  ``engine="host"`` (the host SRGB engine: bit for bit the JAX engine's on
  4:2:0, 4:4:4 and 4:0:0 streams and on the progressive fixture).
- The cases of ``tests/test_host_decode.py`` on the port's bindings of
  ``uhdr_ycbcr_to_rgb888`` and ``uhdr_ycc_to_rgba32``.
- The functions of the reference's exported math surface that no codec
  path runs: ``srgb_luminance`` / ``p3_luminance`` / ``bt2100_luminance``,
  ``hlg_ootf`` / ``hlg_inverse_ootf``, and the float DCT pair
  ``fdct8x8`` / ``idct8x8`` with ``pad_to_block_multiple`` / ``blockify``.
"""

import functools
import importlib
import inspect
import pathlib
import types as pytypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import benchmarks
from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.jpeg import dct as jax_dct
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.jpeg import native as jax_native
from libultrahdr_tpu.ops import colors as jax_colors
from libultrahdr_tpu.ops import effects_device as jax_effects

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import dct as port_dct
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpeg import native as port_native
from libultrahdr_tpu_torch.jpeg.encoder import JpegEncoder
from libultrahdr_tpu_torch.ops import colors as port_colors
from libultrahdr_tpu_torch.ops import effects_device as port_effects

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt

# JAX modules the port holds under another name
PORTED_AS = {"ops/pallas_apply.py": "ops/apply_kernel.py"}

_PACK_ROUTES = ("the XLA and Pallas pack routes; their kernels are "
                "csrc/block_pack_kernel.cu and csrc/pack_kernel.cu, their "
                "v1/v2 routes testing.pack_scans_v1/v2")
# module -> {public name or "function(parameter)": why the port lacks it}
EXCLUDED = {
    "fused.py": {
        "fetch_scan": _PACK_ROUTES + " (the XLA route's byte download)",
        "fetch_blocks": _PACK_ROUTES + " (one scan's drain; the port "
                        "drains both scans with fetch_blocks_multi)",
    },
    "jpeg/device_entropy.py": {n: _PACK_ROUTES for n in (
        "pack_scan_device", "pack_scan_device_v2", "words_to_bytes",
        "use_pack_kernel", "block_buffers_t", "compact_scans",
        "total_words_v2")},
    "jpeg/native.py": {
        **{n: _PACK_ROUTES + " (the XLA route's host stuffing)"
           for n in ("stuff_scan", "stuff_scan_ranges")},
    },
    "jpeg/pack_kernel.py": {
        **{n: _PACK_ROUTES for n in (
            "pack_scan_tiles", "pack_scan_device_kernel",
            "pack_blocks_pallas", "pack_tiles_pallas")},
        "block_buffers_kernel(interpret)": "Pallas's interpret mode; a CUDA "
                                           "kernel has none",
    },
    "ops/pallas_apply.py": {
        "apply_gainmap_pallas": "the Pallas entry; its port is "
                                "apply_kernel.apply_gainmap",
        "TILE_H": "the TPU kernel's tiling", "TILE_W": "the same",
    },
    "ops/pixel.py": {
        "pack_yuv444(chroma_bias)": "unused by every caller, dropped in PR 3",
    },
}
# the K-batch encode (libultrahdr_tpu/fused.py:2604-2700) is private
# (_stitch_image_streams, _dispatch_api0_p010_batch,
# _drain_api0_p010_batch), so no public name stands for it here; it is not
# ported: on the card it made the pipelined encode slower than raw (PERF.md),
# and the port's pipelined encode takes each image's wire instead
# (ROADMAP.md Queue 1 item 12b)


def _modules():
    """(JAX file, JAX module, port module) of every JAX .py module."""
    for f in sorted((REPO / "libultrahdr_tpu").rglob("*.py")):
        rel = f.relative_to(REPO / "libultrahdr_tpu").as_posix()
        yield rel, *(
            f"{pkg}.{r[:-3].replace('/', '.')}".removesuffix(".__init__")
            for pkg, r in (("libultrahdr_tpu", rel),
                           ("libultrahdr_tpu_torch", PORTED_AS.get(rel,
                                                                   rel))))


def _params(fn) -> list | None:
    fn = fn.__func__ if isinstance(fn, (staticmethod, classmethod)) else fn
    try:
        names = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None
    return names[1:] if names[:1] in (["self"], ["cls"]) else names


def _gaps(jmod, pmod) -> list[str]:
    """The JAX module's public names the port lacks, and its functions and
    methods whose parameters do not begin the port's."""
    gaps = []

    def compare(label, jfn, pfn):
        jp, pp = _params(jfn), _params(pfn)
        if jp is not None and pp is not None and pp[:len(jp)] != jp:
            gaps.extend([f"{label}({p})" for p in jp if p not in pp]
                        or [f"{label}: {jp} vs {pp}"])

    for name, val in vars(jmod).items():
        if name.startswith("_") or isinstance(val, pytypes.ModuleType):
            continue
        if (inspect.isfunction(val) or inspect.isclass(val)) and \
                val.__module__ != jmod.__name__:
            continue            # imported from another module: checked there
        if not hasattr(pmod, name):
            gaps.append(name)
            continue
        pval = getattr(pmod, name)
        if inspect.isfunction(val):
            compare(name, val, pval)
        elif inspect.isclass(val):
            for mname, mval in vars(val).items():
                if (mname.startswith("_") and mname != "__init__") or not (
                        inspect.isfunction(mval)
                        or isinstance(mval, (staticmethod, classmethod))):
                    continue
                if not hasattr(pval, mname):
                    gaps.append(f"{name}.{mname}")
                    continue
                compare(f"{name}.{mname}", mval,
                        inspect.getattr_static(pval, mname))
    return gaps


@pytest.mark.parametrize("rel,jname,pname", list(_modules()),
                         ids=[m[0] for m in _modules()])
def test_public_surface_matches_jax(rel, jname, pname):
    gaps = _gaps(importlib.import_module(jname),
                 importlib.import_module(pname))
    excluded = EXCLUDED.get(rel, {})
    assert sorted(set(gaps) - set(excluded)) == []
    # an exclusion that no longer stands for a gap goes
    assert sorted(set(excluded) - set(gaps)) == []


# ---- the signatures of fault F1 ---------------------------------------

def test_ootf_takes_lum_coeffs():
    rs = np.random.RandomState(2)
    rgb = rs.rand(3, 9, 7).astype(np.float32)
    for ct in (CT.HLG, CT.PQ, CT.LINEAR):
        want = np.asarray(jax_colors.ootf(jnp.asarray(rgb), int(ct),
                                          jax_colors.K_BT2100))
        got = port_colors.ootf(torch.from_numpy(rgb), ct,
                               port_colors.K_BT2100)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        assert torch.equal(got, port_colors.ootf(torch.from_numpy(rgb), ct))


@pytest.mark.parametrize("clamp", [True, False])
def test_yuv_to_rgb_clamp(clamp):
    rs = np.random.RandomState(3)
    yuv = (rs.rand(3, 8, 8).astype(np.float32) - [[[0.0]], [[0.5]], [[0.5]]]
           ).astype(np.float32) * 1.6
    m = port_colors.BT2100_YUV2RGB
    want = np.asarray(jax_colors.yuv_to_rgb(jnp.asarray(yuv), m, clamp=clamp))
    got = port_colors.yuv_to_rgb(torch.from_numpy(yuv), m, clamp=clamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.min() < 0 or got.max() > 1) != clamp


def test_apply_effects_packed_takes_the_base_size():
    """Called the JAX way, with the display size: a crop against the given
    size, then a rotation and a resize, equal to JAX's."""
    arr = np.arange(24 * 40, dtype=np.int32).reshape(24, 40)
    port_fx = [port.api.CropEffect(4, 36, 2, 20),
               port.api.RotateEffect(90), port.api.ResizeEffect(6, 8)]
    jax_fx = [jax_api.CropEffect(4, 36, 2, 20), jax_api.RotateEffect(90),
              jax_api.ResizeEffect(6, 8)]
    want, ww, wh = jax_effects.apply_effects_packed(jnp.asarray(arr), jax_fx,
                                                    40, 24)
    got, gw, gh = port_effects.apply_effects_packed(torch.from_numpy(arr),
                                                    port_fx, 40, 24)
    assert (gw, gh) == (ww, wh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # without the size, the array's own: the same here
    got2, *size = port_effects.apply_effects_packed(torch.from_numpy(arr),
                                                    port_fx)
    assert torch.equal(got2, got) and tuple(size) == (gw, gh)
    # the size bounds the crop, as in JAX
    got3, w3, h3 = port_effects.apply_effects_packed(
        torch.from_numpy(arr), [port.api.CropEffect(0, 40, 0, 24)], 20, 12)
    assert (w3, h3) == (20, 12) and tuple(got3.shape) == (12, 20)


@functools.lru_cache(maxsize=None)
def _streams() -> dict:
    """name -> JPEG: a JAX-written JPEG_R's 4:2:0 primary, 4:4:4 and 4:0:0
    JPEGs of an odd-sized image from the port's general encoder, and the
    committed progressive fixture's primary."""
    data = jax_jpegr.JpegR(preset=jax_types.EncPreset.REALTIME).encode_api0(
        benchmarks.photo_p010(96, 64), 90)
    primary, _ = port.JpegR.extract_primary_and_gainmap(data)
    rs = np.random.RandomState(4)
    w, h = 61, 37
    planes = [np.clip(rs.randint(0, 256, (h, w)) // 3 + 80, 0,
                      255).astype(np.uint8) for _ in range(3)]
    enc = JpegEncoder(CPU)
    out = {"420": primary}
    out["444"] = enc.compress(port.RawImage(
        Fmt.YUV444, CG.BT709, CT.SRGB, port.ColorRange.FULL, w, h, planes),
        85)
    out["400"] = enc.compress(port.RawImage(
        Fmt.YUV400, CG.BT709, CT.SRGB, port.ColorRange.FULL, w, h,
        planes[:1]), 85)
    out["progressive"], _ = port.JpegR.extract_primary_and_gainmap(
        testing.PROGRESSIVE_FIXTURE.read_bytes())
    return out


@pytest.mark.parametrize("kind", ["420", "444", "400", "progressive"])
def test_host_srgb_engine_equals_jax(kind):
    data = _streams()[kind]
    want = jax_decoder.decode_to_rgba(data, engine="host")
    got = port_decoder.decode_to_rgba(data, engine="host")
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    planes, fmt = port_decoder.decode_to_planes(data, None, "host")
    jplanes, jfmt = jax_decoder.decode_to_planes(data, None, "host")
    assert int(fmt) == int(jfmt)
    for a, b in zip(planes, jplanes):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


def test_host_and_device_engines_within_a_code():
    """The host engine's IDCT is not libjpeg's islow: within one code of
    the device engine on the CPU, as the JAX package's gate says."""
    data = _streams()["444"]
    host = port_decoder.decode_to_rgba(data, engine="host")
    dev = port_decoder.decode_to_rgba(data, engine="device", device=CPU)
    diff = np.abs(host.view(np.uint8).astype(int) - dev.view(np.uint8))
    assert diff.max() <= 2
    with pytest.raises(port.UhdrError):
        port_decoder.decode_to_rgba(data, engine="tpu")


def test_decode_srgb_host_engine_and_gain_map_equal_jax():
    data = jax_jpegr.JpegR(use_multi_channel_gainmap=True).encode_api0(
        benchmarks.photo_p010(64, 48), 90)
    got, _, gm = port.JpegR(device="cpu").decode(
        data, CT.SRGB, return_gainmap=True, engine="host")
    want, _, wgm = jax_jpegr.JpegR().decode(
        data, jax_types.ColorTransfer.SRGB, return_gainmap=True)
    np.testing.assert_array_equal(got.planes[0], np.asarray(want.planes[0]))
    assert int(gm.fmt) == int(wgm.fmt)
    np.testing.assert_array_equal(gm.planes[0], np.asarray(wgm.planes[0]))


# ---- the host bindings (tests/test_host_decode.py's cases) -------------

def test_native_ycbcr_to_rgb888():
    """Within 1 code of the Rec.601 formula at every pixel, clamped at both
    rails, and equal to the JAX package's binding."""
    rs = np.random.RandomState(11)
    y, cb, cr = [rs.randint(0, 256, (61, 97)).astype(np.uint8)
                 for _ in range(3)]
    got = port_native.ycbcr_to_rgb888(y, cb, cr)
    np.testing.assert_array_equal(got, jax_native.ycbcr_to_rgb888(y, cb, cr))
    yf = y.astype(np.float64)
    u = cb.astype(np.float64) - 128.0
    v = cr.astype(np.float64) - 128.0
    ref = np.stack([np.clip(np.round(c), 0, 255) for c in (
        yf + 1.402 * v, yf - 0.344136286 * u - 0.714136286 * v,
        yf + 1.772 * u)], axis=-1).astype(np.uint8)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    full = port_native.ycbcr_to_rgb888(*[np.full((4, 4), 255, np.uint8)] * 3)
    assert full[..., 0].max() == 255 and full.min() >= 0
    zero = port_native.ycbcr_to_rgb888(*[np.zeros((4, 4), np.uint8)] * 3)
    assert zero[..., 2].min() == 0


def test_native_ycc_to_rgba32_matches_the_device_twin():
    """uhdr_ycc_to_rgba32 equals the port's ``_ycc_to_rgb`` (libjpeg's
    integer upsample and conversion, on the CPU) packed as RGBA8888, and
    the JAX package's binding, for every sampling and odd size."""
    rs = np.random.RandomState(1)
    for key, (cwd, chd) in [("444", (1, 1)), ("420", (2, 2)),
                            ("422", (2, 1)), ("440", (1, 2)),
                            ("411", (4, 1)), ("410", (4, 2))]:
        for (h, w) in [(64, 96), (31, 49), (8, 8), (17, 254), (2, 2)]:
            cw, ch = -(-w // cwd), -(-h // chd)
            y = rs.randint(0, 256, (h, w)).astype(np.uint8)
            cb = rs.randint(0, 256, (ch, cw)).astype(np.uint8)
            cr = rs.randint(0, 256, (ch, cw)).astype(np.uint8)
            ref = port_decoder._ycc_to_rgb(
                *(torch.from_numpy(p) for p in (y, cb, cr)), key, h,
                w).numpy().astype(np.uint32)
            refp = ref[0] | (ref[1] << 8) | (ref[2] << 16) | \
                np.uint32(0xFF000000)
            got = port_native.ycc_to_rgba32(y, cb, cr, key, h, w)
            np.testing.assert_array_equal(got, refp, err_msg=f"{key} {h}x{w}")
            np.testing.assert_array_equal(
                got, jax_native.ycc_to_rgba32(y, cb, cr, key, h, w))


# ---- the exported math surface ------------------------------------------

RGB_BLACK = np.zeros(3, np.float32)
RGB_WHITE = np.ones(3, np.float32)


@pytest.mark.parametrize("fn,coeffs", [
    ("srgb_luminance", (0.212639, 0.715169, 0.072192)),
    ("p3_luminance", (0.2289746, 0.6917385, 0.0792869)),
    ("bt2100_luminance", (0.2627, 0.677998, 0.059302))])
def test_luminance_functions(fn, coeffs):
    """tests/test_colors.py's primaries and white, and JAX's values on
    random colours."""
    f = getattr(port_colors, fn)
    assert abs(float(f(torch.from_numpy(RGB_BLACK)))) < 1e-6
    assert abs(float(f(torch.from_numpy(RGB_WHITE))) - 1.0) < 1e-5
    for i, k in enumerate(coeffs):
        prim = np.zeros(3, np.float32)
        prim[i] = 1.0
        assert abs(float(f(torch.from_numpy(prim))) - k) < 1e-6
    rgb = np.random.RandomState(7).rand(3, 5, 6).astype(np.float32)
    np.testing.assert_array_equal(
        f(torch.from_numpy(rgb)).numpy(),
        np.asarray(getattr(jax_colors, fn)(jnp.asarray(rgb))))


def test_hlg_ootf_pair():
    """tests/test_colors.py's white and round trip, and JAX's values."""
    out = port_colors.hlg_ootf(torch.from_numpy(RGB_WHITE),
                               port_colors.K_BT2100)
    np.testing.assert_allclose(out.numpy(), [1, 1, 1], atol=1e-6)
    rgb = np.random.default_rng(1).random((3, 8, 8), np.float32) + 0.01
    fwd = port_colors.hlg_ootf(torch.from_numpy(rgb), port_colors.K_BT2100)
    back = port_colors.hlg_inverse_ootf(fwd, port_colors.K_BT2100)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-3)
    jfwd = jax_colors.hlg_ootf(jnp.asarray(rgb), jax_colors.K_BT2100)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), rtol=1e-6)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_colors.hlg_inverse_ootf(
            jfwd, jax_colors.K_BT2100)), rtol=1e-5)


def test_float_dct_pair():
    """tests/test_jpeg.py's round trip and DC term, and JAX's values."""
    rng = np.random.default_rng(0)
    blocks = (rng.random((10, 8, 8)).astype(np.float32) - 0.5) * 255
    coeffs = port_dct.fdct8x8(torch.from_numpy(blocks))
    back = port_dct.idct8x8(coeffs)
    np.testing.assert_allclose(back.numpy(), blocks, atol=1e-3)
    np.testing.assert_allclose(
        coeffs.numpy(), np.asarray(jax_dct.fdct8x8(jnp.asarray(blocks))),
        atol=2e-4)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_dct.idct8x8(jax_dct.fdct8x8(
            jnp.asarray(blocks)))), atol=2e-4)
    dc = port_dct.fdct8x8(torch.full((1, 8, 8), 127.0))
    assert float(dc[0, 0, 0]) == pytest.approx(8 * 127.0, abs=1e-2)
    assert float(dc[0].abs().sum()) == pytest.approx(8 * 127.0, abs=1e-2)


@pytest.mark.parametrize("fill", [None, 9])
def test_pad_to_block_multiple_and_blockify(fill):
    plane = np.random.RandomState(8).randint(0, 256, (13, 21)).astype(
        np.uint8)
    got = port_dct.pad_to_block_multiple(torch.from_numpy(plane), fill)
    want = np.asarray(jax_dct.pad_to_block_multiple(jnp.asarray(plane),
                                                    fill))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port_dct.blockify(got).numpy(),
        np.asarray(jax_dct.blockify(jnp.asarray(want))))
    aligned = torch.from_numpy(plane[:8, :16].copy())
    assert torch.equal(port_dct.pad_to_block_multiple(aligned, fill), aligned)
