"""The port's tests' guard on the first use of the JAX package's C++.

``libultrahdr_tpu/jpeg/native.py`` compiles its library at first use into
``UHDR_TPU_CACHE`` (else ``~/.cache/libultrahdr_tpu``) through one fixed
temporary name, ``<lib>.so.tmp``, with no lock.  Test workers that reach it
first at the same time race: one loads a file another is still writing
("file too short"), or renames a temporary file another has already moved
(FileNotFoundError).

Every port test file that imports the JAX package calls
``guard_jax_native()`` when it is imported.  The test workers each collect
every file before they run a test, so the library is built once, under an
``fcntl`` lock in that same cache directory, and every later caller finds
the finished file (``_build`` returns early when it exists) before any test
of any worker runs.  The JAX package itself is not changed.

The guard also sets PyTorch's CPU ops to one intra-op thread in the worker
that runs it: six test workers of eight threads each on an eight-core host
spent most of their time waiting on one another (twelve 256x128 encodes in
each of six processes: 73 s with eight threads, 0.65 s with one).  The
port's results do not depend on the thread count.
"""

from __future__ import annotations

import fcntl
import multiprocessing
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def jax_native_cache() -> pathlib.Path:
    """The directory the JAX package's ``native._build`` writes to."""
    return pathlib.Path(os.environ.get(
        "UHDR_TPU_CACHE", os.path.expanduser("~/.cache/libultrahdr_tpu")))


def guard_jax_native():
    """Build (or load) the JAX package's C++ library while holding an
    exclusive lock on ``.port_tests.lock`` in its cache directory, and run
    torch's CPU ops on one thread; returns the JAX ``native`` module."""
    import torch
    from libultrahdr_tpu.jpeg import native as jax_native
    torch.set_num_threads(1)
    cache = jax_native_cache()
    cache.mkdir(parents=True, exist_ok=True)
    with open(cache / ".port_tests.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jax_native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return jax_native


def _guarded_child(cache: str, results) -> None:
    os.environ["UHDR_TPU_CACHE"] = cache
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    try:
        import numpy as np
        jax_native = guard_jax_native()
        # a call into the loaded library: its 10-bit pack of 32 samples
        out = jax_native.pack_p010_10bit(np.arange(32, dtype=np.uint16) << 6)
        results.put(("ok", out.size > 0))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        results.put((type(e).__name__, str(e)[:200]))


def test_every_port_test_file_that_imports_jax_is_guarded():
    """Each ``test_torch_*.py`` that imports the JAX package at its top
    level calls the guard at its top level too."""
    import ast
    unguarded = []
    for f in sorted(HERE.glob("test_torch_*.py")):
        body = ast.parse(f.read_text()).body
        imports_jax = any(
            isinstance(n, ast.ImportFrom) and (n.module or "").split(".")[0]
            == "libultrahdr_tpu" or isinstance(n, ast.Import) and any(
                a.name.split(".")[0] == "libultrahdr_tpu" for a in n.names)
            for n in body)
        guarded = any(
            isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
            and getattr(n.value.func, "id", "") == "guard_jax_native"
            for n in body)
        if imports_jax and not guarded:
            unguarded.append(f.name)
    assert unguarded == []


def test_guard_builds_once_for_concurrent_processes(tmp_path):
    """Six spawned processes go through the guard at once against an
    empty cache: each loads the library and calls it, none fails, and the
    cache holds one library and no temporary file."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    cache = tmp_path / "cache"
    procs = [ctx.Process(target=_guarded_child, args=(str(cache), results))
             for _ in range(6)]
    for p in procs:
        p.start()
    got = [results.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    assert got == [("ok", True)] * 6
    assert all(p.exitcode == 0 for p in procs)
    names = sorted(f.name for f in cache.iterdir())
    assert len([n for n in names if n.endswith(".so")]) == 1
    assert not [n for n in names if n.endswith(".tmp")]
