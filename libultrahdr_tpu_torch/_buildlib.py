"""Build-at-first-use for the port's native libraries.

Both the shared host C++ (the restart-row joiner and the scan decoder, compiled
by path from ``libultrahdr_tpu/jpeg/_native``) and the CUDA kernels under
``csrc/`` are compiled on first use into ``libultrahdr_tpu_torch/_build/``,
a directory that ``.gitignore`` lists.  Each library is keyed by a hash of its
sources and its command line, so an edited source rebuilds.  A file lock makes
concurrent first uses (test workers, several processes on one checkout) build
once; the finished library is moved into place atomically.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import subprocess

PKG_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"


def build_shared(name: str, sources: list[pathlib.Path],
                 command: list[str]) -> tuple[pathlib.Path, str]:
    """Compile `sources` into ``_build/<name>_<hash>.so`` unless present.

    `command` is the compiler invocation without sources and output; the
    sources and ``-o <tmp>`` are appended.  Returns (library path, the
    compiler's stderr of the build, or "" when the library was cached).
    A failed build raises RuntimeError carrying the compiler's output."""
    blob = b"".join(s.read_bytes() for s in sources)
    blob += " ".join(command).encode()
    tag = hashlib.sha256(blob).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}_{tag}.so"
    if so.exists():
        return so, ""
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():
                return so, ""
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                command + [str(s) for s in sources] + ["-o", str(tmp)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed (exit {proc.returncode}): "
                    f"{' '.join(proc.args)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
            return so, proc.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
