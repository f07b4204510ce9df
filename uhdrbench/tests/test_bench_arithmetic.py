"""The harness's statistics, the trace's interval arithmetic and the
roofline readers' byte counts at 12 MP."""

import importlib.util
import json
import random

import pytest

from uhdrbench import harness, trace


def test_p95_is_over_every_request():
    lat = [0.010] * 100
    assert harness.p95(lat) == 0.010
    stalled = lat[:94] + [0.500] * 6
    assert harness.p95(stalled) == 0.500
    random.Random(3).shuffle(stalled)
    assert harness.p95(stalled) == 0.500


def test_p95_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([7]) == 7


def test_union_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_length(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert trace.gaps(iv, -1.0, 2.0) == [(-1.0, 0.0)]
    ops = [trace.Op("k", "kernel", s, e) for s, e in iv]
    tr = trace.Trace(ops, [], (0.0, 5.0), [], [], {}, {})
    assert tr.busy_s() == pytest.approx(3.0)
    idle = harness.metric_reader("device.idle_pct")(tr)
    assert idle == pytest.approx(40.0)


def load(metric):
    """A metric file as a module (its byte arithmetic)."""
    spec = importlib.util.spec_from_file_location(
        "m", harness.HERE / "metrics" / f"{metric}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name, scan_mb, apply_mb", [
    ("android_12mp", 58.8, 69.7), ("libdefault_12mp", 169.2, 106.5)])
def test_interface_bytes_at_12mp(name, scan_mb, apply_mb):
    cfg = _cfg(name)
    sb = load("scan_kernel.roofline_pct").scan_bytes(cfg)
    ab = load("apply_kernel.roofline_pct").apply_bytes(cfg)
    cb = load("pack_kernel.roofline_pct").coefficient_bytes(cfg)
    assert sb / 1e6 == pytest.approx(scan_mb, abs=0.1)
    assert ab / 1e6 == pytest.approx(apply_mb, abs=0.1)
    # the pack reads the scan's coefficients: its output half
    assert cb == sb - (cfg["width"] * cfg["height"] * 3 // 2
                       + (3 if cfg["multichannel_map"] else 1)
                       * (cfg["width"] // cfg["map_scale"])
                       * (cfg["height"] // cfg["map_scale"]))


def test_roofline_reader_shares():
    cfg = _cfg("android_12mp")
    reqs = [(0.0, 0.1, 12.5)] * 4
    read = harness.metric_reader("scan_kernel.roofline_pct")
    ops = [trace.Op("scan_kernel<false>(ScanParams)", "kernel", 0.0, 1e-4)
           for _ in range(8)]
    tr = trace.Trace(ops, [], (0.0, 1.0), reqs, [], cfg, {})
    bound = 4 * 58.8e6 / 3.35e12
    assert read(tr) == pytest.approx(100 * bound / 8e-4, rel=1e-3)
    assert harness.metric_reader("apply_kernel.roofline_pct")(tr) is None


def test_pack_reader_counts_entropy_bytes():
    m = load("pack_kernel.roofline_pct")
    sos = b"\xff\xda\x00\x08" + bytes(6)
    data = b"\xff\xd8" + sos + b"\x01\x02\xff\x00\x03" + b"\xff\xd9"
    assert m.entropy_bytes(data + data) == 10
