"""The port's guided parser fuzzer (libultrahdr_tpu_torch/fuzz/fuzz_parsers)
against the JAX package's (fuzz/fuzz_parsers.py).

Every file of the JAX package's committed corpus (fuzz/corpus/<target>/),
every file of the port's (libultrahdr_tpu_torch/fuzz/corpus/<target>/)
and seeded mutants of the port's seeds go through both packages' seven
targets on the CPU.  The gate: the same verdict; on accept the same parsed
values (offsets, ISO fractions and their floats, XMP and header fields,
the probe's dict, the decoded planes) and bit-exact scan coefficients; on
reject a port exception in the port's CLEAN.  Then a bounded guided run of
the port's fuzzer for each target, in a subprocess, must find no crash."""

import dataclasses
import enum
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fuzz import fuzz_parsers as jfuzz
from libultrahdr_tpu.container import icc as jax_icc
from libultrahdr_tpu.container import iso21496 as jax_iso
from libultrahdr_tpu.container import xmp as jax_xmp
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.jpeg import native as jax_native
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu_torch.container import icc as port_icc
from libultrahdr_tpu_torch.container import iso21496 as port_iso
from libultrahdr_tpu_torch.container import xmp as port_xmp
from libultrahdr_tpu_torch.fuzz import fuzz_parsers as pfuzz
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpegr import JpegR
from libultrahdr_tpu_torch import types as port_types

from test_torch_jax_native import guard_jax_native

guard_jax_native()

REPO = pathlib.Path(__file__).resolve().parents[1]
# seeded mutants of each target's seeds (beside both committed corpora)
MUTANTS = {"scan": 120, "iso": 150, "xmp": 120, "icc": 120,
           "jpeg_parse": 120, "jpeg_decode": 40, "probe": 80}


def plain(x):
    """A value of either package as plain Python for ==: dataclasses and
    dicts by field, arrays and tensors by dtype, shape and bytes, enums by
    value, floats by their bits (NaN == NaN), Huffman tables by their
    counts and symbols."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (bool, int, str, bytes, type(None))):
        return x
    if isinstance(x, (float, np.floating)):
        return ("f", np.float64(x).tobytes())
    if isinstance(x, np.integer):
        return int(x)
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "bits") and hasattr(x, "values"):
        return ("huff", list(x.bits), list(x.values))
    raise TypeError(f"no plain form for {type(x)}")


def verdict(fn, data):
    """("ok", value) or ("reject", exception)."""
    try:
        return "ok", fn(data)
    except Exception as e:  # noqa: BLE001 - the verdict is the point
        return "reject", e


def jax_coeffs(data):
    """The JAX package's host coefficient decode of `data` (the front half
    of its decode_to_planes)."""
    info = jax_decoder.parse_jpeg(data)
    jax_decoder._validate(info)
    hmax = max(c.h for c in info.components)
    vmax = max(c.v for c in info.components)
    mw, mh = -(-info.width // (8 * hmax)), -(-info.height // (8 * vmax))
    comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
             for c in info.components]
    if info.progressive:
        return jax_decoder._decode_progressive_coeffs(data, info, comps, mw,
                                                      mh, hmax, vmax)
    return jax_native.decode_scan(
        data[info.scan_offset:], comps, mw, mh,
        [info.dc_tables.get(i) for i in range(4)],
        [info.ac_tables.get(i) for i in range(4)], info.restart_interval)[0]


def extra_values(name, data):
    """Values each package derives from an accepted input beyond the
    target's return: the ISO fractions' floats and their float_to_fraction,
    the scan coefficients."""
    if name == "iso":
        out = []
        for iso in (jax_iso, port_iso):
            ok, md = verdict(iso.fraction_to_float,
                             iso.decode_gainmap_metadata(data))
            again = verdict(iso.float_to_fraction, md) if ok == "ok" \
                else ("reject", None)
            out.append((ok, plain(md) if ok == "ok" else None, again[0],
                        plain(again[1]) if again[0] == "ok" else None))
        return out
    if name == "jpeg_decode":
        info = port_decoder.parse_jpeg(data)
        if info.width * info.height > pfuzz.MAX_DECODE_PIXELS:
            return None
        coeffs, _, _ = port_decoder.decode_coefficients(data, info)
        return plain(jax_coeffs(data)), plain(coeffs)
    return None


def inputs(name):
    """The JAX corpus, the port corpus and seeded mutants of the port's
    seeds (the seeds first)."""
    jax_dir = REPO / "fuzz" / "corpus" / name
    files = [f.read_bytes() for f in sorted(jax_dir.iterdir())] \
        if jax_dir.is_dir() else []
    seeds = pfuzz.make_seeds(name)
    rs = np.random.RandomState(1234)
    return files + pfuzz.corpus_files(name) + seeds + [
        pfuzz.mutate(rs, seeds) for _ in range(MUTANTS[name])]


@pytest.fixture(scope="module")
def cpu_jpegr():
    return JpegR(device="cpu")


@pytest.mark.parametrize("name", sorted(pfuzz.TARGETS))
def test_port_targets_match_jax(name, cpu_jpegr):
    jfn = jfuzz.TARGETS[name]
    pfn = pfuzz.TARGETS[name]
    n = accepted = 0
    for i, data in enumerate(inputs(name)):
        jv, jval = verdict(jfn, data)
        pv, pval = verdict(lambda d: pfn(d, cpu_jpegr), data)
        what = f"{name} input {i} ({len(data)} bytes)"
        assert not isinstance(jval, Exception) or \
            isinstance(jval, jfuzz.CLEAN), f"{what}: JAX crashed: {jval!r}"
        assert jv == pv, f"{what}: JAX {jv} {jval!r}, port {pv} {pval!r}"
        if pv == "reject":
            assert isinstance(pval, pfuzz.CLEAN), f"{what}: {pval!r}"
        else:
            assert plain(pval) == plain(jval), what
            extra = extra_values(name, data)
            if extra is not None:
                assert extra[0] == extra[1], what
            accepted += 1
        n += 1
    assert n > MUTANTS[name] and 0 < accepted


def test_seed_writers_match_jax():
    """The writers the seeds come from give the JAX package's bytes: ISO
    21496-1 blocks and the float_to_fraction result, both XMP packets,
    every ICC profile."""
    jmd, pmd = jax_types.GainMapMetadata(), pfuzz.seed_metadata()
    for f in ("max_content_boost", "min_content_boost", "gamma",
              "offset_sdr", "offset_hdr"):
        getattr(jmd, f)[:] = getattr(pmd, f)
    jmd.hdr_capacity_min, jmd.hdr_capacity_max = \
        pmd.hdr_capacity_min, pmd.hdr_capacity_max
    for b in (False, True):
        jmd.use_base_cg = pmd.use_base_cg = b
        jfrac, pfrac = jax_iso.float_to_fraction(jmd), \
            port_iso.float_to_fraction(pmd)
        assert plain(jfrac) == plain(pfrac)
        assert jax_iso.encode_gainmap_metadata(jfrac) == \
            port_iso.encode_gainmap_metadata(pfrac)
    assert jax_xmp.generate_xmp_for_secondary_image(jmd) == \
        port_xmp.generate_xmp_for_secondary_image(pmd)
    assert jax_xmp.generate_xmp_for_primary_image(1234, jmd) == \
        port_xmp.generate_xmp_for_primary_image(1234, pmd)
    for ct in ("SRGB", "HLG", "PQ", "LINEAR"):
        for cg in ("BT709", "DISPLAY_P3", "BT2100"):
            assert jax_icc.write_icc_profile(
                jax_types.ColorTransfer[ct], jax_types.ColorGamut[cg]) == \
                port_icc.write_icc_profile(port_types.ColorTransfer[ct],
                                           port_types.ColorGamut[cg])
    assert pfuzz.make_seeds("icc") == [
        jax_icc.write_icc_profile(jax_types.ColorTransfer[ct],
                                  jax_types.ColorGamut[cg])
        for ct in ("SRGB", "HLG", "PQ", "LINEAR")
        for cg in ("BT709", "DISPLAY_P3", "BT2100")]


def test_committed_corpus_is_small_and_replays_clean(cpu_jpegr):
    """The port's committed corpus stays within the JAX package's size and
    every file of it is a clean input for every target."""
    files = [f for f in pfuzz.CORPUS.rglob("*") if f.is_file()]
    jax_bytes = sum(f.stat().st_size for f in
                    (REPO / "fuzz" / "corpus").rglob("*") if f.is_file())
    assert files and sum(f.stat().st_size for f in files) <= jax_bytes
    assert {f.parent.name for f in files} <= set(pfuzz.TARGETS)
    for f in files:
        for name, fn in pfuzz.TARGETS.items():
            try:
                fn(f.read_bytes(), cpu_jpegr)
            except pfuzz.CLEAN:
                pass


def test_mutate_is_the_jax_stack():
    """The same RNG stream gives the same mutants in both packages."""
    seeds = pfuzz.make_seeds("probe") + pfuzz.make_seeds("iso")
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(300):
        assert pfuzz.mutate(a, seeds) == jfuzz.mutate(b, seeds)


# cheap byte-level parsers get more execs, stream-level targets fewer
BUDGETS = {"scan": 400, "iso": 400, "xmp": 300, "icc": 400,
           "jpeg_parse": 300, "jpeg_decode": 150, "probe": 150}


@pytest.mark.parametrize("target", sorted(BUDGETS))
def test_guided_fuzz_clean(target):
    # a subprocess: sys.monitoring's line events must not fight pytest's
    # own tracing, and a crashing parser must not take the test down
    r = subprocess.run(
        [sys.executable, "-m", "libultrahdr_tpu_torch.fuzz.fuzz_parsers",
         "--target", target, "--execs", str(BUDGETS[target]), "--seed", "3",
         "--device", "cpu", "--no-save"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, \
        f"fuzz {target} found crashes:\n{r.stdout}\n{r.stderr[-3000:]}"
    assert f"[{target}] {BUDGETS[target]} execs on cpu, 0 crashes" in r.stdout


def test_fuzzer_defaults_to_the_card(monkeypatch):
    """With no GPU the fuzzer's default device raises a coded error before
    any exec: nothing runs on the CPU instead."""
    from libultrahdr_tpu_torch.errors import UhdrError, UhdrErrorCode
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UhdrError) as e:
        pfuzz.main(["--target", "iso", "--execs", "1", "--no-save"])
    assert e.value.code == UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
