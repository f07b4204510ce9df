"""The port's sanitizer gates on the CPU.

``python -m libultrahdr_tpu_torch.tools.sanitize_replay`` (the port of
tools/sanitize_replay.py) rebuilds the host C++ and the C-ABI shim with
ASan and UBSan, replays the committed corpus through the parsers and the
natives, drives the other natives with adversarial inputs and runs the C
programs, all in a child with libasan preloaded: it must exit 0.  The
sanitized builds have names of their own and leave the default build as
it is.  ``tools/sanitize_kernels.py`` is the card's program (compute-
sanitizer, guard pages): here its cases run on CPU tensors, where every
wrapper takes its plain version, so only the harness is checked."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from libultrahdr_tpu_torch import _buildlib
from libultrahdr_tpu_torch.capi import build as capi_build
from libultrahdr_tpu_torch.jpeg import native
from libultrahdr_tpu_torch.tools import sanitize_kernels as sk
from libultrahdr_tpu_torch.tools import sanitize_replay as sr

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_sanitize_replay():
    if sr.find_libasan() is None:
        pytest.skip("no libasan.so for g++ on this host")
    env = {k: v for k, v in os.environ.items()
           if k not in ("UHDR_TPU_SANITIZE", "UHDR_CAPI_SANITIZE")}
    r = subprocess.run(
        [sys.executable, "-m", "libultrahdr_tpu_torch.tools.sanitize_replay"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, \
        f"sanitizer findings:\n{r.stdout[-4000:]}\n{r.stderr[-6000:]}"
    lines = r.stdout.splitlines()
    assert lines[-1] == "SANITIZE REPLAY OK"
    assert any(ln.startswith("replayed ") for ln in lines)
    for exe in ("capi_asan_smoke_asan", "test_capi_asan",
                "capi_roundtrip_asan"):
        assert any(ln.startswith(f"sanitized {exe}_") for ln in lines), exe


def test_sanitized_host_build_is_its_own(monkeypatch):
    """UHDR_TPU_SANITIZE=1 names the host library jpeg_entropy_asan and
    builds it with the JAX package's sanitizer flags; unset, the build is
    the -O3 one, so no unsanitized process loads the ASan library."""
    monkeypatch.delenv("UHDR_TPU_SANITIZE", raising=False)
    name, srcs, command, key = native.build_args()
    assert name == "jpeg_entropy" and "-O3" in command
    assert not any("sanitize" in c for c in command)
    default = _buildlib.library_path(name, srcs, command, key)
    monkeypatch.setenv("UHDR_TPU_SANITIZE", "1")
    sname, ssrcs, scommand, skey = native.build_args()
    assert sname == "jpeg_entropy_asan" and ssrcs == srcs and skey == key
    for flag in ("-O1", "-g", "-fsanitize=address,undefined",
                 "-fno-sanitize-recover=all"):
        assert flag in scommand
    sanitized = _buildlib.library_path(sname, ssrcs, scommand, skey)
    assert sanitized.name.startswith("jpeg_entropy_asan_")
    assert sanitized != default


def test_sanitized_capi_builds_are_their_own(monkeypatch):
    monkeypatch.delenv("UHDR_CAPI_SANITIZE", raising=False)
    assert not capi_build.sanitize()
    monkeypatch.setenv("UHDR_CAPI_SANITIZE", "1")
    assert capi_build.sanitize()
    calls = []

    def fake_build(name, sources, command, key="", libs=(), suffix=".so"):
        calls.append((name, command))
        return _buildlib.BUILD_DIR / f"{name}_x{suffix}", ""

    monkeypatch.setattr(capi_build, "build_shared", fake_build)
    shim = capi_build.build_shim(linked=True)
    capi_build.build_shim(linked=False)
    capi_build.build_program("test_capi", shim)
    capi_build.build_program("capi_asan_smoke", shim, sr.SMOKE_C)
    assert [n for n, _ in calls] == [
        "libuhdr_tpu_torch_asan", "libuhdr_tpu_torch_inproc_asan",
        "test_capi_asan", "capi_asan_smoke_asan"]
    for _, command in calls:
        assert all(f in command for f in capi_build.SANITIZE_FLAGS)


def test_sanitize_kernels_cases_cover_every_kernel():
    """Every kernel has small and 4K cases; on CPU tensors each case runs
    (the wrapper takes its plain version) and launches nothing."""
    small = {k for k, *_ in sk.cases(torch.device("cpu"), "small")}
    assert small == set(sk.KERNELS)
    stats = sk.run(torch.device("cpu"), "small", log=lambda m: None)
    assert set(stats) == set(sk.KERNELS)
    assert all(st["cases"] > 0 and st["launches"] == 0
               for st in stats.values())
    assert stats["forward_dct"]["cases"] == 47
    assert stats["pack_tiles"]["cases"] == 10


def test_sanitize_kernels_4k_cases_cover_every_kernel():
    big = [(k, what) for k, what, *_ in sk.cases(torch.device("cpu"), "4k")]
    assert {k for k, _ in big} == set(sk.KERNELS)
    assert ("pack_scan", "both 4K scans, 583200 blocks") in big


def test_sanitize_kernels_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="runs only on a GPU"):
        sk.main(["--tool", "memcheck"])
