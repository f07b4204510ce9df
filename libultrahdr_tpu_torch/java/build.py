"""Build the port's Java binding: javac the classes, g++ the JNI shim
against the port's C ABI shim (``capi/build.py``, the variant linked
against libpython).

    python -m libultrahdr_tpu_torch.java.build [--out DIR]
    python -m libultrahdr_tpu_torch.java.build --syntax-only
    python -m libultrahdr_tpu_torch.java.build --link-stub

The full build needs a JDK (javac and ``$JAVA_HOME/include/jni.h``) and
writes the class tree and ``libuhdr_tpu_torch_jni.so`` (the name the
classes' ``System.loadLibrary("uhdr_tpu_torch_jni")`` loads) into --out
(default ``libultrahdr_tpu_torch/_build/java``).  Without a JDK,
``--syntax-only`` compiles the JNI C++ against the stub ``jni/stub/jni.h``
and ``--link-stub`` links it against the shim into
``_build/libuhdr_tpu_torch_jni_stub_<hash>.so``: a link check (every
``native`` method exported, every ABI symbol resolved), never loaded by a
JVM, since the stub's function table is not the JVM's.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess

from .._buildlib import BUILD_DIR, build_shared
from ..capi.build import CAPI_DIR, build_shim

JAVA_DIR = pathlib.Path(__file__).resolve().parent
JNI_SRC = JAVA_DIR / "jni" / "uhdr_jni.cpp"
STUB_DIR = JAVA_DIR / "jni" / "stub"
JAVA_SOURCES = [
    JAVA_DIR / "com/google/media/codecs/ultrahdr/UltraHDRCommon.java",
    JAVA_DIR / "com/google/media/codecs/ultrahdr/UltraHDREncoder.java",
    JAVA_DIR / "com/google/media/codecs/ultrahdr/UltraHDRDecoder.java",
]
_CXX = ["g++", "-std=c++17", "-Wall", "-Werror"]


def find_java_home() -> pathlib.Path | None:
    jh = os.environ.get("JAVA_HOME")
    if jh and (pathlib.Path(jh) / "include/jni.h").exists():
        return pathlib.Path(jh)
    javac = shutil.which("javac")
    if javac:
        home = pathlib.Path(os.path.realpath(javac)).parent.parent
        if (home / "include/jni.h").exists():
            return home
    return None


def syntax_check() -> None:
    """Compile the JNI shim against the stub jni.h (no JDK required)."""
    subprocess.run(_CXX + ["-fsyntax-only", f"-I{STUB_DIR}", f"-I{CAPI_DIR}",
                           str(JNI_SRC)], check=True)


def link_stub() -> pathlib.Path:
    """Link the JNI shim, built against the stub jni.h, against the C ABI
    shim with no undefined symbol left (no JDK required)."""
    shim = build_shim(linked=True)
    so, _ = build_shared(
        "libuhdr_tpu_torch_jni_stub", [JNI_SRC],
        _CXX + ["-O2", "-shared", "-fPIC", f"-I{STUB_DIR}", f"-I{CAPI_DIR}"],
        key=(STUB_DIR / "jni.h").read_text()
        + (CAPI_DIR / "ultrahdr_tpu.h").read_text(),
        libs=[str(shim), f"-Wl,-rpath,{shim.parent}", "-Wl,--no-undefined"])
    return so


def build(out: pathlib.Path) -> None:
    java_home = find_java_home()
    if java_home is None:
        raise RuntimeError("no JDK found (need javac and jni.h); run with "
                           "--syntax-only or --link-stub for the no-JDK gates")
    classes = out / "classes"
    classes.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [str(java_home / "bin/javac"), "-d", str(classes)]
        + [str(s) for s in JAVA_SOURCES] + [str(JAVA_DIR / "UltraHdrApp.java")],
        check=True)
    shim = build_shim(linked=True)
    plat_inc = next((java_home / "include").glob("linux"), None) \
        or next((java_home / "include").glob("darwin"),
                java_home / "include")
    subprocess.run(
        _CXX + ["-O2", "-shared", "-fPIC", str(JNI_SRC),
                f"-I{java_home / 'include'}", f"-I{plat_inc}", f"-I{CAPI_DIR}",
                str(shim), f"-Wl,-rpath,{shim.parent}",
                "-o", str(out / "libuhdr_tpu_torch_jni.so")],
        check=True)
    print(f"built {out / 'libuhdr_tpu_torch_jni.so'} + classes in {classes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(BUILD_DIR / "java"))
    ap.add_argument("--syntax-only", action="store_true")
    ap.add_argument("--link-stub", action="store_true")
    args = ap.parse_args(argv)
    if args.syntax_only:
        syntax_check()
        print("JNI shim syntax check OK")
    elif args.link_stub:
        print(f"linked {link_stub()}")
    else:
        build(pathlib.Path(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
