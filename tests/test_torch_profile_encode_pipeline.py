"""The port's wire-route profile of the pipelined encode, on the CPU.

``libultrahdr_tpu_torch/tools/profile_encode_pipeline.py`` splits the
pipelined API-0 P010 encode over UHDR_TPU_WIRE=vw and auto into host pack,
upload, device stage (with the un-slice kernel's share) and drain, and times
the pipelined call over raw and each wire in turns.  On the card it reports
CUDA-event times; here it runs its CPU route at 256x128 on 2 frames: every
stage runs, every file equals the raw route's, and no device metric is
reported.
"""

import json

import pytest
import torch

from libultrahdr_tpu_torch.tools import profile_encode_pipeline as pep


def test_profile_encode_pipeline_cpu(tmp_path, capsys):
    assert pep.main(["--device", "cpu", "--width", "256", "--height", "128",
                     "--frames", "2", "--reps", "1", "--out",
                     str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = json.loads((tmp_path / "encode_pipeline_profile.json").read_text())
    assert printed == res
    assert res["device"] == {"type": "cpu", "name": "cpu", "card": None}
    assert res["files_equal_raw"] is True
    assert set(res["configs"]) == {"benchmark", "default"}
    for cfg in res["configs"].values():
        assert set(cfg) == {"raw", "vw", "auto"}
        assert cfg["raw"]["upload_mb"] == pytest.approx(256 * 128 * 3 / 1e6)
        assert len(cfg["raw"]["pipelined_ms_per_image"]) == 2
        for mode in ("vw", "auto"):
            st = cfg[mode]
            assert st["wires"] == ["vw"]
            assert len(st["pipelined_ms_per_image"]) == 2
            assert st["device_ms"] is None and st["unslice_ms"] is None
            for k in ("wire_mb", "pack_ms", "upload_ms", "compute_host_ms",
                      "drain_ms"):
                assert st[k] > 0


def test_profile_encode_pipeline_needs_the_card_by_default(monkeypatch):
    """The default device is the card; without one the tool stops."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        pep.main(["--frames", "1", "--reps", "1", "--width", "64",
                  "--height", "32"])
