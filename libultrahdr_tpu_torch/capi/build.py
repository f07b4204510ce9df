"""Build the port's C ABI shim (uhdr_capi.cpp) and the C programs on it.

    python -m libultrahdr_tpu_torch.capi.build            # both shims
    python -m libultrahdr_tpu_torch.capi.build --test     # + test_capi.c

Everything goes through ``_buildlib.build_shared`` into the git-ignored
``libultrahdr_tpu_torch/_build/``, keyed by a hash of the sources, the
header and the command line, under the build lock.  The shim comes in two
variants from the one source:

- ``build_shim(linked=True)``: linked against libpython, for stand-alone C
  programs (``test_capi.c``, ``capi_roundtrip.c``, the JNI binding);
- ``build_shim(linked=False)``: no ``-lpython``; its Python symbols come
  from the process that loads it, a running interpreter, through
  ``ctypes.CDLL`` (``abi.load``).

A stand-alone program embeds an interpreter that does not know the calling
one's ``sys.path`` (a venv's site-packages among it): run it with
``embed_env()``.  It runs every codec on the card unless
``UHDR_TPU_TORCH_DEVICE`` names another torch device.

``UHDR_CAPI_SANITIZE=1`` (the JAX package's knob) builds the shims and the
C programs with ASan and UBSan (``-O1 -g -fsanitize=address,undefined
-fno-sanitize-recover=all``) under names of their own (``*_asan``); a
program links the ASan runtime itself, so the sanitized shim loads in it
(``tools/sanitize_replay.py`` runs them).
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import sysconfig

from .._buildlib import PKG_DIR, build_shared

CAPI_DIR = pathlib.Path(__file__).resolve().parent
HEADER = CAPI_DIR / "ultrahdr_tpu.h"


def python_embed_flags() -> tuple[list[str], list[str]]:
    """(cflags, ldflags) for embedding this interpreter."""
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        f"{sys.version_info.major}.{sys.version_info.minor}"
    ld = [f"-L{libdir}", f"-lpython{ver}"]
    for extra in (sysconfig.get_config_var("LIBS") or "").split():
        ld.append(extra)
    return [f"-I{inc}"], ld


def _header_key() -> str:
    return hashlib.sha256(HEADER.read_bytes()).hexdigest()


SANITIZE_FLAGS = ["-O1", "-g", "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=all"]


def sanitize() -> bool:
    """UHDR_CAPI_SANITIZE=1: the ASan + UBSan builds."""
    return os.environ.get("UHDR_CAPI_SANITIZE") == "1"


def build_shim(linked: bool = True) -> pathlib.Path:
    """The shim library; `linked` selects the libpython-linked variant."""
    cflags, ldflags = python_embed_flags()
    name = "libuhdr_tpu_torch" if linked else "libuhdr_tpu_torch_inproc"
    opt = SANITIZE_FLAGS if sanitize() else ["-O2"]
    so, _ = build_shared(
        name + ("_asan" if sanitize() else ""),
        [CAPI_DIR / "uhdr_capi.cpp"],
        ["g++", *opt, "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         f"-I{CAPI_DIR}", *cflags],
        key=_header_key(), libs=ldflags if linked else [])
    return so


def build_program(name: str, shim: pathlib.Path | None = None,
                  source: pathlib.Path | None = None) -> pathlib.Path:
    """``<name>.c`` of this directory (or `source`) as an executable linked
    against the libpython-linked shim (built first unless given)."""
    shim = shim or build_shim(linked=True)
    opt = SANITIZE_FLAGS if sanitize() else ["-O1"]
    exe, _ = build_shared(
        name + ("_asan" if sanitize() else ""),
        [source or CAPI_DIR / f"{name}.c"],
        ["gcc", *opt, "-pthread", "-Wall", "-Werror", f"-I{CAPI_DIR}"],
        key=_header_key(), libs=[str(shim), f"-Wl,-rpath,{shim.parent}"],
        suffix="")
    return exe


def embed_env(env: dict | None = None) -> dict:
    """`env` (default os.environ) with PYTHONPATH set to this checkout and
    the calling interpreter's sys.path, for a program that embeds one."""
    env = dict(os.environ if env is None else env)
    path = [str(PKG_DIR.parent)] + [p for p in sys.path if p]
    if env.get("PYTHONPATH"):
        path.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(path)
    return env


def main() -> int:
    shim = build_shim(linked=True)
    print(f"shim (linked against libpython): {shim}")
    print(f"shim (for ctypes.CDLL in a running interpreter): "
          f"{build_shim(linked=False)}")
    if "--test" in sys.argv:
        exe = build_program("test_capi", shim)
        return subprocess.run([str(exe)], env=embed_env()).returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
