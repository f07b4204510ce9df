"""The benchmark's encode cells against its plain reference on the CPU, at
small sizes of each configuration's shape: the Android camera's
single-client encode (``android_12mp.encode_c1``) and libultrahdr's
library defaults at 8K (``libdefault_8k.encode_api0_c1``: API-0 with a
full-size 3-channel map, the case that no other cell's test covers).

- The program on a seeded pool lies within each cell's limits, and the
  control (the reference in bfloat16) outside at least one of them.
- A run whose encodes have a flipped scan byte reads ``correct`` false; a
  sound run reads it true.
- The configuration has the keys of the others, cuts nothing, and its
  preset does not change an API-0 encode's bytes.
- Every per-layer metric that lists a new cell has its reader."""

import json
import pathlib

import pytest

from libultrahdr_tpu_torch import api, testing
from libultrahdr_tpu_torch.types import ColorTransfer, EncPreset, ImgLabel
from uhdrbench import control, harness

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the 12 MP cells' 4:3 and the 8K frame's 1.90:1, each at a CPU size
SIZES = {"android_12mp.encode_c1": (256, 192),
         "libdefault_8k.encode_api0_c1": (512, 272)}
CELLS = sorted(SIZES)


@pytest.mark.parametrize("cell", CELLS)
def test_port_within_limits_and_control_outside(cell):
    spec, cfg = harness.load_cell(cell)
    r = control.readings(cell, 2 ** 31 + 23, "cpu", SIZES[cell])
    prog, ctl = r["program"], r["control"]
    assert prog["faults"] == 0
    assert all(prog[k] <= lim for k, lim in spec["limits"].items()), prog
    assert any(ctl[k] > lim for k, lim in spec["limits"].items()), ctl


def test_8k_cell_checks_a_full_size_3_channel_map():
    import numpy as np
    import torch
    from uhdrbench import scene
    from uhdrbench.reference import codec
    spec, cfg = harness.load_cell("libdefault_8k.encode_api0_c1")
    w, h = SIZES["libdefault_8k.encode_api0_c1"]
    cfg = dict(cfg, width=w, height=h)
    (y, uv), = scene.pool(w, h, 1, 5)
    exp = codec.encode_expectation(
        cfg, *(torch.from_numpy(p.view(np.int16)) for p in (y, uv)))
    assert exp["map_channels"] == 3
    assert [tuple(c.shape) for c in exp["map"]] == [(h // 8, w // 8, 64)] * 3


@pytest.fixture
def run(monkeypatch):
    """``harness.run_cell`` on the CPU at the cell's small size.  This
    suite's conftest loads JAX for its JAX tests, so the run's guard
    against JAX in the process (``uhdrbench/tests/test_bench_guard.py``
    tests it) is told that none is loaded."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])

    def one(cell, seed):
        return harness.run_cell(cell, seed, 1.0, False, device="cpu",
                                size=SIZES[cell], out=lambda s: None,
                                err=lambda s: None)
    return one


def _flip_scan_byte(data: bytes) -> bytes:
    b = bytearray(data)
    sos = b.find(b"\xff\xda")
    b[sos + 200] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("cell", CELLS)
def test_altered_encode_answer_is_not_correct(monkeypatch, run, cell):
    orig = api.UhdrEncoder.encode
    monkeypatch.setattr(api.UhdrEncoder, "encode",
                        lambda self: _flip_scan_byte(orig(self)))
    assert run(cell, 77)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run, cell):
    res = run(cell, 3 * 2 ** 31 + 5)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"mpps", "p95_ms", "setup_s"}


def test_8k_configuration_keys_and_cuts():
    new = json.loads((ROOT / "uhdrbench/configs/libdefault_8k.json")
                     .read_text())
    old = json.loads((ROOT / "uhdrbench/configs/libdefault_12mp.json")
                     .read_text())
    assert set(new) == set(old)
    assert new["reduced"] == []
    assert (new["width"], new["height"]) == (8192, 4320)
    for k in ("base_quality", "map_quality", "map_scale",
              "multichannel_map", "metadata", "hdr_transfer", "gamma"):
        assert new[k] == old[k], k
    entry = next(c for c in BENCH["configs"] if c["name"] == "libdefault_8k")
    assert entry["reduced"] == [] and entry["file"].endswith(
        "libdefault_8k.json")


def test_api0_bytes_do_not_depend_on_the_preset():
    """API-0 makes the one-pass map whatever the preset, so the 8K
    configuration's REALTIME (what the plain reference keys its map on)
    and the library's default BEST_QUALITY give one file."""
    def encode(preset):
        img = testing.photo_p010(128, 96)
        img.ct = ColorTransfer.PQ
        enc = api.UhdrEncoder(device="cpu")
        enc.set_raw_image(img, ImgLabel.HDR)
        enc.set_quality(95, ImgLabel.BASE)
        enc.set_quality(95, ImgLabel.GAIN_MAP)
        enc.set_gainmap_scale_factor(1)
        enc.set_using_multi_channel_gainmap(True)
        enc.set_preset(preset)
        return enc.encode()
    assert encode(EncPreset.REALTIME) == encode(EncPreset.BEST_QUALITY)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_metrics_have_readers(cell):
    names = [m["name"] for m in BENCH["per_layer"]
             if cell in m.get("workloads", [])]
    assert len(names) == 10
    for name in names:
        assert callable(harness.metric_reader(name))
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert w["chips"] == 1
    assert harness.load_cell(cell)[0]["clients"] == 1
