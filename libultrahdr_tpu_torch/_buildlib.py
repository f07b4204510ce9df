"""Build-at-first-use for the port's native libraries.

Both the shared host C++ (the restart-row joiner and the scan decoder, compiled
by path from ``libultrahdr_tpu/jpeg/_native``) and the CUDA kernels under
``csrc/`` (each through ``build_cuda``, one nvcc command line for all) are
compiled on first use into ``libultrahdr_tpu_torch/_build/``,
a directory that ``.gitignore`` lists.  Each library is keyed by a hash of its
sources and its command line, so an edited source rebuilds.  A file lock makes
concurrent first uses (test workers, several processes on one checkout) build
once; the finished library is moved into place atomically.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

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


def nvcc() -> str:
    """The CUDA compiler: nvcc on PATH, else under CUDA_HOME (default
    /usr/local/cuda)."""
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_cuda(name: str, source: pathlib.Path):
    """Compile one ``csrc/*.cu`` file with nvcc for sm_90a into a shared
    library with a plain C interface and load it.  ``-Xptxas -v`` makes the
    build log carry each kernel's registers, shared memory and spills.

    Returns (ctypes library, build log, seconds).  Every kernel source
    exports ``uhdr_cuda_error_string``, which is bound here."""
    t0 = time.perf_counter()
    so, log = build_shared(
        name, [source],
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])
    lib = ctypes.CDLL(str(so))
    lib.uhdr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uhdr_cuda_error_string.restype = ctypes.c_char_p
    return lib, log, time.perf_counter() - t0


def check_launch(lib, rc: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.uhdr_cuda_error_string(rc).decode()}")
