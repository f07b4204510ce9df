"""PyTorch port: the benchmark tools (``tools/benchmarks.py``,
``tools/bench.py``) against the JAX repository's ``benchmarks.py`` and
``bench.py``, on the CPU at small sizes.

- The scenes equal the JAX harness's plane for plane at 96x64 and 130x66:
  ``grainy_p010``, ``bench.make_scene``, the ``mosaic`` scene (the JAX
  harness's fallback to ``make_scene``; skipped only where the JAX harness
  would read the reference's fixture instead), ``photo_p010`` and both RGB
  repacks, and ``bench._scene_imgs``; where the JAX function raises at a
  size, the port's raises the same exception.
- ``benchmarks.main(["--device", "cpu", ...])`` gives the JAX harness's row
  names in its order for every section (the JAX harness run with stand-ins
  for its codec, so only its names and artifact are read), every row's
  checks pass, and the artifact has the JAX artifact's keys less
  ``reference_anchor``, plus ``scene_note``; a wrong output fails its row
  and the exit code.
- ``bench.main(["--device", "cpu", ...])`` prints one JSON line with the
  headline's name; every pipelined file equals its single encode, and a
  pipelined file that differs raises.
- With no GPU and no ``--device`` both raise ``UhdrError``.
"""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
import benchmarks as jax_benchmarks
from libultrahdr_tpu import api as jax_api

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused, testing
from libultrahdr_tpu_torch.tools import bench, benchmarks

SIZES = [(96, 64), (130, 66)]


def _planes(img):
    return [np.asarray(p) for p in img.planes]


def _photo(w, h):
    return jax_benchmarks.photo_p010(w, h)


SCENES = {
    "grainy": (lambda w, h: _planes(jax_benchmarks.grainy_p010(w, h)),
               lambda w, h: _planes(benchmarks.grainy_p010(w, h))),
    "make_scene": (lambda w, h: list(jax_bench.make_scene(w, h)),
                   lambda w, h: list(bench.make_scene(w, h))),
    "mosaic": (lambda w, h: _planes(jax_benchmarks.natural_p010(w, h)),
               lambda w, h: _planes(benchmarks.natural_p010(w, h))),
    "photo": (lambda w, h: _planes(jax_benchmarks.photo_p010(w, h)),
              lambda w, h: _planes(benchmarks.SCENES["photo"](w, h))),
    "rgba1010102": (
        lambda w, h: _planes(jax_benchmarks._p010_to_rgba1010102(
            _photo(w, h))),
        lambda w, h: _planes(benchmarks._p010_to_rgba1010102(
            benchmarks.SCENES["photo"](w, h)))),
    "rgbaf16": (
        lambda w, h: _planes(jax_benchmarks._p010_to_rgbaf16(_photo(w, h))),
        lambda w, h: _planes(benchmarks._p010_to_rgbaf16(
            benchmarks.SCENES["photo"](w, h)))),
}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_equals_the_jax_harness(scene, size):
    if scene == "mosaic" and jax_benchmarks._FIXTURE.exists():
        pytest.skip("the JAX harness reads the reference's fixture here")
    want_fn, got_fn = SCENES[scene]
    try:
        want = want_fn(*size)
    except Exception as e:            # the JAX function refuses the size
        with pytest.raises(type(e)):
            got_fn(*size)
        return
    got = got_fn(*size)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g, x)


def test_scene_imgs_equal_the_jax_harness(monkeypatch):
    monkeypatch.setattr(jax_bench, "W", 96)
    monkeypatch.setattr(jax_bench, "H", 64)
    want = jax_bench._scene_imgs(jax_benchmarks.photo_p010, 3)
    got = bench._scene_imgs(benchmarks.SCENES["photo"], 3, w=96, h=64)
    assert len(got) == len(want) == 3
    for g, x in zip(got, want):
        assert (g.fmt, g.w, g.h) == (int(x.fmt), x.w, x.h)
        for pg, px in zip(g.planes, x.planes):
            np.testing.assert_array_equal(pg, px)


class _JaxCodecStandIn:
    """What the JAX harness's rows call, doing nothing: the harness runs
    only for its row names and artifact."""

    def __init__(self, *a, **kw):
        pass

    def encode_api0(self, *a, **kw):
        return b""

    encode_api1 = encode_api0

    def tone_map(self, hdr):
        return hdr

    def decode(self, *a, **kw):
        return None

    decode_host = decode

    def decode_to_device(self, *a, **kw):
        return np.zeros((1, 4), np.uint32), None

    set_image = set_out_color_transfer = set_out_img_format = decode


def _small(maker, w=64, h=48):
    """A scene maker that makes at most w x h, whatever size it is asked
    for (the 8K row's name without its 8K encode)."""
    return lambda rw, rh: maker(min(rw, w), min(rh, h))


ARGS = ["--size", "64x48", "--reps", "1", "--diagnostics", "--with-8k"]


def test_benchmarks_rows_and_artifact(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(jax_benchmarks, "JpegR", _JaxCodecStandIn)
    monkeypatch.setattr(jax_api, "UhdrDecoder", _JaxCodecStandIn)
    monkeypatch.setattr(jax_benchmarks, "photo_p010",
                        _small(jax_benchmarks.photo_p010))
    assert jax_benchmarks.main(ARGS + ["--json", str(tmp_path / "j.json")]) \
        == 0
    want = json.loads((tmp_path / "j.json").read_text())

    monkeypatch.setitem(benchmarks.SCENES, "photo",
                        _small(benchmarks.SCENES["photo"]))
    assert benchmarks.main(ARGS + ["--device", "cpu", "--json",
                                   str(tmp_path / "p.json")]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    capsys.readouterr()

    assert [r["config"] for r in got["rows"]] == \
        [r["config"] for r in want["rows"]]
    names = [r["config"] for r in got["rows"]]
    for section in ("enc api0", "enc api1", "dec single", "dec multi",
                    "8k ("):
        assert any(section in n for n in names), section
    for r in got["rows"]:
        assert r["failed"] == 0 and r["errors"] == [], r
        assert r["attempted"] == (8 if "serving" in r["config"] else 1)
        serving = "serving" in r["config"]
        assert r["n"] == (2 if serving else 1)
        assert r["min_ms"] <= r["ms"] <= r["max_ms"]
        assert r["calls"] == (24 if serving else 2)
        assert set(r["launches"]) == {*benchmarks.kernel_counters(),
                                      "apply_linear"}
        assert not any(r["launches"].values())    # plain versions on CPU
    assert set(got) == (set(want) - {"reference_anchor"}) | {"scene_note"}
    assert set(got["row_notes"]) == set(want["row_notes"])
    assert (got["resolution"], got["scene"], got["device"]) == \
        ("64x48", "photo", "cpu")


def test_benchmarks_counts_a_failed_check(monkeypatch, tmp_path, capsys):
    """A host engine whose output is wrong fails its rows' gate, and the
    exit code; the other rows pass."""
    real = port.JpegR.decode_host

    def zeroed(self, *a, **kw):
        dest, md = real(self, *a, **kw)
        dest.planes[0][:] = 0
        return dest, md

    monkeypatch.setattr(port.JpegR, "decode_host", zeroed)
    out = tmp_path / "p.json"
    assert benchmarks.main(["--device", "cpu", "--size", "32x32", "--reps",
                            "1", "--section", "dec", "--json", str(out)]) == 1
    capsys.readouterr()
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) == 26
    for r in rows:
        assert r["failed"] == int("(host)" in r["config"]), r


def test_bench_headline_line(capsys):
    assert bench.main(["--device", "cpu", "--size", "64x48"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "extra"}
    assert (line["metric"], line["unit"]) == ("api0_encode_4k_p010_hlg",
                                              "MP/s")
    extra = line["extra"]
    assert extra["card"] == "cpu" and extra["pipelined_equal_single"]
    assert line["value"] > 0 and extra["encode_median_4k_mpps"] > 0
    for k in ("decode_host_4k_hlg_mpps", "decode_serving_4k_hlg_mpps",
              "decode_device_single_4k_hlg_mpps", "encode_grainy_4k_mpps",
              "decode_host_grainy_4k_mpps", "encode_mosaic_4k_mpps",
              "decode_host_mosaic_4k_mpps"):
        assert extra[k] > 0, k
    assert (extra["encode_wire_mode"], extra["link_h2d_mbps"],
            extra["encode_device_compute_4k_ms"]) == ("vw", None, None)
    assert extra["encode_wire_bytes_per_img"] > 0
    assert not any(k.endswith("vs_baseline") for k in extra)


def test_bench_pipelined_files_equal_single_encodes(monkeypatch):
    jr = port.JpegR(map_dimension_scale_factor=4,
                    use_multi_channel_gainmap=False, preset=0, device="cpu")
    b = bench.Bench(jr, port.JpegR(device="cpu"))
    imgs = bench._scene_imgs(testing.photo_p010, 4, w=64, h=48)
    _, _, outs, _ = b.encode(imgs, reps=1)
    assert outs == [jr.encode_api0(img, quality=95) for img in imgs]

    real = fused.encode_api0_p010_pipelined

    def one_wrong(*a, **kw):
        files = real(*a, **kw)
        return files[:-1] + [files[-1][:-2] + b"\xff\xd9\xff\xd9"]

    monkeypatch.setattr(fused, "encode_api0_p010_pipelined", one_wrong)
    with pytest.raises(AssertionError, match="pipelined file 3"):
        b.encode(imgs, reps=1)


@pytest.mark.parametrize("tool", ["benchmarks", "bench"])
def test_tools_default_to_the_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"benchmarks": benchmarks.main, "bench": bench.main}[tool]
    with pytest.raises(port.UhdrError) as e:
        main(["--size", "64x48", "--reps", "1"] if tool == "benchmarks"
             else ["--size", "64x48"])
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
