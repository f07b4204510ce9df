"""PyTorch port: the Java/JNI binding (libultrahdr_tpu_torch/java/) against
the JAX package's (java/).

- The JNI shim compiles with -Wall -Werror against the stub jni.h and links
  against the port's C ABI shim (the variant linked against libpython) with
  no undefined symbol: no JDK needed, every JNI call goes through the env's
  function table.
- Every ``native`` method of the three classes has its JNI export, in the
  source and in the linked library's dynamic symbols (``nm -D``).
- The port's Java API surface (public methods, constants, natives) equals
  the JAX binding's; the classes load ``uhdr_tpu_torch_jni``, so the two
  bindings' libraries can share one ``java.library.path``.
- Where a JDK exists, the full build and an encode/decode round trip on
  the CPU (``UHDR_TPU_TORCH_DEVICE=cpu``); no JDK here, so it skips.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from libultrahdr_tpu_torch.capi import build as capi_build
from libultrahdr_tpu_torch.java import build as java_build

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_JAVA = REPO / "java"
PORT_JAVA = REPO / "libultrahdr_tpu_torch" / "java"
PKG = "com/google/media/codecs/ultrahdr"
CLASSES = ["UltraHDRCommon", "UltraHDREncoder", "UltraHDRDecoder"]


def _native_names(java_file: pathlib.Path) -> list[str]:
    return re.findall(r"native\s+[\w\[\]]+\s+(\w+)\s*\(", java_file.read_text())


def _surface(java_file: pathlib.Path) -> dict:
    """Public method and field declarations and native declarations, with
    comments dropped and whitespace normalised, and the library the class
    loads."""
    src = re.sub(r"/\*.*?\*/|//[^\n]*", " ", java_file.read_text(),
                 flags=re.S)
    src = re.sub(r"\s+", " ", src)
    return {
        "public": sorted(re.findall(r"public [^;{=]*?\([^)]*\)", src)),
        "fields": sorted(re.findall(r"public static final [^;]*;", src)),
        "natives": sorted(re.findall(r"native [^;]*;", src)),
        "loads": re.findall(r'System\.loadLibrary\("(\w+)"\)', src),
    }


def test_jni_shim_syntax():
    """g++ -fsyntax-only -Wall -Werror against the stub jni.h."""
    subprocess.run([sys.executable, "-m", "libultrahdr_tpu_torch.java.build",
                    "--syntax-only"], check=True, cwd=REPO)


@pytest.fixture(scope="module")
def jni_stub_lib():
    return java_build.link_stub()


def test_jni_links_against_the_port_shim(jni_stub_lib):
    """The full link (-Wl,--no-undefined) names the port's shim, linked
    against libpython, and no JNI symbol is left to resolve."""
    needed = subprocess.run(["readelf", "-d", str(jni_stub_lib)], check=True,
                            capture_output=True, text=True).stdout
    assert str(capi_build.build_shim(linked=True)) in needed
    undefined = subprocess.run(
        ["nm", "-D", "--undefined-only", str(jni_stub_lib)], check=True,
        capture_output=True, text=True).stdout
    assert "JNIEnv" not in undefined and "uhdr_create_encoder" in undefined


@pytest.mark.parametrize("cls", CLASSES)
def test_every_java_native_has_a_jni_export(cls, jni_stub_lib):
    """In the JNI source and among the linked library's exports."""
    names = _native_names(PORT_JAVA / PKG / f"{cls}.java")
    assert names == _native_names(JAX_JAVA / PKG / f"{cls}.java")
    cpp = (PORT_JAVA / "jni/uhdr_jni.cpp").read_text()
    exported = set(subprocess.run(
        ["nm", "-D", "--defined-only", str(jni_stub_lib)], check=True,
        capture_output=True, text=True).stdout.split())
    for n in names:
        sym = f"Java_com_google_media_codecs_ultrahdr_{cls}_{n}"
        assert sym in cpp and sym in exported, sym


@pytest.mark.parametrize("cls", CLASSES)
def test_java_api_surface_equals_the_jax_binding(cls):
    port = _surface(PORT_JAVA / PKG / f"{cls}.java")
    jax = _surface(JAX_JAVA / PKG / f"{cls}.java")
    assert port["loads"] == ["uhdr_tpu_torch_jni"] and jax["loads"] == [
        "uhdr_tpu_jni"]
    for key in ("public", "fields", "natives"):
        assert port[key] == jax[key], key
    assert port["public"]


def test_sample_app_equals_the_jax_binding_s():
    """UltraHdrApp.java: the same code below its header comment."""
    port, jax = ((d / "UltraHdrApp.java").read_text().split("*/", 1)[1]
                 for d in (PORT_JAVA, JAX_JAVA))
    assert port == jax


def test_java_roundtrip_with_jdk(tmp_path):
    """Full build and an encode/decode round trip through the JVM, on the
    CPU (runs only where a JDK exists)."""
    if java_build.find_java_home() is None or shutil.which("java") is None:
        pytest.skip("no JDK on this host")
    out = tmp_path / "out"
    subprocess.run([sys.executable, "-m", "libultrahdr_tpu_torch.java.build",
                    "--out", str(out)], check=True, cwd=REPO)
    w, h = 96, 64
    rs = np.random.RandomState(7)
    y = (rs.randint(0, 1024, (h, w)).astype("<u2") << 6)
    uv = (rs.randint(300, 700, (h // 2, w)).astype("<u2") << 6)
    p010 = tmp_path / "in.p010"
    p010.write_bytes(y.tobytes() + uv.tobytes())
    env = capi_build.embed_env({**os.environ, "LD_LIBRARY_PATH": str(out),
                                "UHDR_TPU_TORCH_DEVICE": "cpu"})
    java = ["java", "-cp", f"{out}/classes", f"-Djava.library.path={out}",
            "UltraHdrApp"]
    subprocess.run(java + ["encode", str(p010), str(w), str(h),
                           str(tmp_path / "out.jpg")], check=True, env=env)
    from libultrahdr_tpu_torch.jpegr import is_uhdr_image
    assert is_uhdr_image((tmp_path / "out.jpg").read_bytes())
    subprocess.run(java + ["decode", str(tmp_path / "out.jpg"),
                           str(tmp_path / "out.raw")], check=True, env=env)
    assert np.fromfile(tmp_path / "out.raw", dtype="<u4").size == w * h
