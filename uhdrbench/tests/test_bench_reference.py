"""The plain reference against the port at a small size on the CPU, the
control against the reference, and a run with the timed path broken."""

import numpy as np
import pytest

from uhdrbench import control, harness

SIZE = (256, 192)
CELLS = ["android_12mp.encode_c4", "libdefault_12mp.encode_api1_c4",
         "android_12mp.decode_hlg_c1", "libdefault_12mp.decode_pq_c4"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_within_limits_and_control_outside(cell):
    spec, _ = harness.load_cell(cell)
    r = control.readings(cell, 2 ** 31 + 11, "cpu", SIZE)
    prog, ctl = r["program"], r["control"]
    assert prog["faults"] == 0
    assert all(prog[k] <= lim for k, lim in spec["limits"].items()), prog
    assert any(ctl[k] > lim for k, lim in spec["limits"].items()), ctl


def _broken_run(monkeypatch, cell, alter):
    from libultrahdr_tpu_torch import api
    name = "decode" if "decode" in cell else "encode"
    orig = getattr(api.UhdrEncoder if name == "encode" else api.UhdrDecoder,
                   name)

    def broken(self):
        return alter(orig(self))
    monkeypatch.setattr(api.UhdrEncoder if name == "encode"
                        else api.UhdrDecoder, name, broken)
    lines = []
    res = harness.run_cell(cell, 77, 1.0, False, device="cpu", size=SIZE,
                           out=lines.append, err=lines.append)
    return res


def _flip_scan_byte(data: bytes) -> bytes:
    b = bytearray(data)
    sos = b.find(b"\xff\xda")
    b[sos + 200] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("cell", CELLS[:2])
def test_altered_encode_answer_is_not_correct(monkeypatch, cell):
    res = _broken_run(monkeypatch, cell, _flip_scan_byte)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS[2:])
def test_altered_decode_answer_is_not_correct(monkeypatch, cell):
    def alter(img):
        p = np.array(img.planes[0], copy=True)
        p[10:18, 20:28] ^= np.uint32(0x3FF)
        img.planes[0] = p
        return img
    res = _broken_run(monkeypatch, cell, alter)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS[2:])
def test_sound_run_is_correct(cell):
    res = harness.run_cell(cell, 78, 1.0, False, device="cpu", size=SIZE,
                           out=lambda s: None, err=lambda s: None)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
