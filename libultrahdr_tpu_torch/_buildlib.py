"""Build-at-first-use for the port's native libraries.

Both the host C++ (the restart-row joiner, the scan decoder and the scan
encoder, the port's own copy under ``csrc/host/``) and the CUDA kernels under
``csrc/`` (each a ``CudaLibrary``, built through ``build_cuda``, one nvcc
command line for all) are compiled on first use into ``libultrahdr_tpu_torch/_build/``,
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
import threading
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


class CudaLibrary:
    """One ``csrc/<name>.cu`` library, built by build_cuda at first use
    (once, under a lock) with the argument types of its C entry points
    bound; every entry point returns a CUDA error code (check_launch)."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = PKG_DIR / "csrc" / f"{name}.cu"
        self.signatures = signatures    # entry point -> ctypes argtypes
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (or load the cached) library; returns it."""
        with self._lock:
            if self._lib is None:
                lib, self.build_log, self.build_seconds = build_cuda(
                    self.name, self.source)
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return self._lib


def check_launch(lib, rc: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.uhdr_cuda_error_string(rc).decode()}")
