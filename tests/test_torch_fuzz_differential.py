"""The harness of the port's differential fuzzer
(libultrahdr_tpu_torch/fuzz/differential.py) with both sides on the CPU:
the mutant generator, the saving of each input before its decode, the
collection of what a child left behind and the verdict logic.  On the card
chip_smoke.py runs it with the card against the CPU."""

import json

import pytest
import torch

from libultrahdr_tpu_torch.errors import UhdrError, UhdrErrorCode
from libultrahdr_tpu_torch.fuzz import differential as diff
from libultrahdr_tpu_torch.fuzz import fuzz_parsers as pfuzz
from libultrahdr_tpu_torch.jpegr import JpegR


@pytest.fixture(scope="module")
def seeds():
    return diff.make_seeds()


def test_seeds_are_cpu_encodes(seeds):
    """The 96x48 file at map scale 2 and the 256x128 one at scale 4 with a
    3-channel map, then the committed probe corpus."""
    jr = JpegR(device="cpu")
    info = [jr.get_info(s) for s in seeds[:2]]
    assert [(i["width"], i["height"]) for i in info] == [(96, 48), (256, 128)]
    assert [(i["gainmap"].width, i["gainmap"].height,
             i["gainmap"].num_components) for i in info] == [
        (48, 24, 1), (64, 32, 3)]
    assert seeds[2:] == pfuzz.corpus_files("probe")
    assert seeds[:2] == diff.make_seeds()[:2]


def test_mutants_are_seeded(seeds):
    a = list(diff.mutants(seeds, 60, seed=4))
    assert a == list(diff.mutants(seeds, 60, seed=4))
    assert a != list(diff.mutants(seeds, 60, seed=5))
    assert [i for i, _ in a] == list(range(60))
    assert a[0][1] == seeds[0] and a[1][1] == seeds[1]
    # the light mutants flip bits of a seed past its first 600 bytes
    for i, data in a[3::2]:
        base = seeds[0] if len(data) == len(seeds[0]) else seeds[1]
        assert len(data) == len(base) and data[:600] == base[:600]
        assert data != base


def test_compare_cpu_against_cpu_is_clean(seeds):
    for data in seeds[:2]:
        assert diff.compare(data, "cpu", "cpu") == ([], True)
    assert diff.compare(b"\xff\xd8\xff\xd9", "cpu", "cpu") == ([], False)


def test_compare_verdict_logic(monkeypatch, seeds):
    """A different verdict or an output outside the decode contract is a
    fault; a coded reject on both sides is none."""
    real = diff.decode
    out, _ = real(seeds[0], "cpu", "HLG")

    def one_sided(data, device, ct):
        if device == "cuda":
            return None, UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR, "x")
        return real(data, "cpu", ct)

    monkeypatch.setattr(diff, "decode", one_sided)
    faults, accepted = diff.compare(seeds[0], "cuda", "cpu")
    assert accepted and len(faults) == 2 and "cuda UHDR_CODEC_ERROR" in \
        faults[0]

    def off_by_much(data, device, ct):
        got, e = real(data, "cpu", ct)
        if device == "cuda" and got is not None:
            got = got.copy()
            got.reshape(-1)[::7] ^= 0x3FF
        return got, e

    monkeypatch.setattr(diff, "decode", off_by_much)
    faults, _ = diff.compare(seeds[0], "cuda", "cpu")
    assert len(faults) == 2 and all("decode contract" in f for f in faults)
    assert out is not None


def test_child_writes_each_mutant_before_it_decodes(monkeypatch, tmp_path,
                                                    seeds):
    """A crash (any exception but a coded reject) ends the child with the
    mutant at fault in ``current``; ``collect`` keeps its bytes under
    crashes/ and names its index."""
    monkeypatch.setattr(pfuzz, "CRASHES", tmp_path / "crashes")
    monkeypatch.setattr(diff, "CRASHES", tmp_path / "crashes")
    mut = dict(diff.mutants(diff.make_seeds(), 9, 0))
    calls = []

    def crash_at_7(data, device, reference_device):
        calls.append(data)
        if len(calls) == 8:
            raise RuntimeError("CUDA error: an illegal memory access")
        return [], True

    monkeypatch.setattr(diff, "compare", crash_at_7)
    work = tmp_path / "work"
    work.mkdir()
    with pytest.raises(RuntimeError):
        diff.child(work, 9, 0, "cpu", "cpu")
    assert (work / "current").read_bytes() == mut[7]
    summary = diff.collect(work, 1)
    assert summary["crash"] == 7 and not summary["ok"]
    kept = [p for p in (tmp_path / "crashes").iterdir()]
    assert [p.read_bytes() for p in kept] == [mut[7]]
    assert kept[0].name.startswith("diff-crash-7-")


def test_child_records_faults_and_ends(monkeypatch, tmp_path):
    monkeypatch.setattr(diff, "CRASHES", tmp_path / "crashes")
    mut = dict(diff.mutants(diff.make_seeds(), 6, 0))

    def fault_at_4(data, device, reference_device):
        return (["HLG: made up"] if data == mut[4] else []), True

    monkeypatch.setattr(diff, "compare", fault_at_4)
    work = tmp_path / "work"
    work.mkdir()
    assert diff.child(work, 6, 0, "cpu", "cpu") == 1
    s = json.loads((work / "summary.json").read_text())
    assert (s["execs"], s["accepted"], s["rejected"], s["faults"]) == \
        (6, 6, 0, 1)
    summary = diff.collect(work, 1)
    assert not summary["ok"] and summary["crash"] is None
    assert [f["index"] for f in summary["faults_seen"]] == [4]
    assert [p.read_bytes() for p in (tmp_path / "crashes").iterdir()] == \
        [mut[4]]


def test_run_cpu_against_cpu():
    """The whole harness in its child process: 40 mutants, no fault, no
    kernel launch on the CPU."""
    s = diff.run(40, seed=2, device="cpu", reference_device="cpu",
                 timeout=600)
    assert s["ok"], s
    assert s["accepted"] + s["rejected"] == 40 and s["accepted"] > 0
    assert s["rejected"] > 0 and s["saved"] == []
    assert set(s["launches"].values()) == {0}
    assert s["ms_per_mutant"] > 0


def test_differential_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UhdrError) as e:
        diff.main(["--execs", "1"])
    assert e.value.code == UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
