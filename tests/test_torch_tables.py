"""PyTorch port: constants, container bytes, configuration and import
guards against the JAX package.

The port copies the JAX package's host-only modules (tables, container
writers) and must keep them byte-for-byte equivalent; it must import
without jax, and a CUDA request without a GPU must raise rather than run on
the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmarks
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.container import icc as jax_icc
from libultrahdr_tpu.container import jpegr_container as jax_container
from libultrahdr_tpu.jpeg import dct as jax_dct
from libultrahdr_tpu.jpeg import encoder as jax_encoder
from libultrahdr_tpu.jpeg import tables as jax_tables
from libultrahdr_tpu.ops import colors as jax_colors
from libultrahdr_tpu.ops import lut_parity as jax_lut

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import api as port_api
from libultrahdr_tpu_torch import jpegr as port_jpegr
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch import types as port_types
from libultrahdr_tpu_torch.container import icc as port_icc
from libultrahdr_tpu_torch.container import jpegr_container as port_container
from libultrahdr_tpu_torch.jpeg import dct as port_dct
from libultrahdr_tpu_torch.jpeg import encoder as port_encoder
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pack
from libultrahdr_tpu_torch.jpeg import tables as port_tables
from libultrahdr_tpu_torch.ops import colors as port_colors
from libultrahdr_tpu_torch.ops import lut_parity as port_lut

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_version_matches():
    import libultrahdr_tpu
    assert port.__version__ == libultrahdr_tpu.__version__ == "1.4.0"


@pytest.mark.parametrize("quality", [1, 50, 90, 95, 100])
def test_quant_tables_equal(quality):
    np.testing.assert_array_equal(port_tables.STD_LUMA_QUANT,
                                  jax_tables.STD_LUMA_QUANT)
    np.testing.assert_array_equal(port_tables.STD_CHROMA_QUANT,
                                  jax_tables.STD_CHROMA_QUANT)
    for base in ("STD_LUMA_QUANT", "STD_CHROMA_QUANT"):
        np.testing.assert_array_equal(
            port_tables.scaled_quant_table(getattr(port_tables, base),
                                           quality),
            jax_tables.scaled_quant_table(getattr(jax_tables, base),
                                          quality))


@pytest.mark.parametrize("name", ["DC_LUMA", "DC_CHROMA", "AC_LUMA",
                                  "AC_CHROMA"])
def test_huffman_tables_equal(name):
    p, j = getattr(port_tables, name), getattr(jax_tables, name)
    assert p.bits == j.bits and p.values == j.values
    np.testing.assert_array_equal(p.code_of, j.code_of)
    np.testing.assert_array_equal(p.size_of, j.size_of)


def test_zigzag_dct_and_lut_constants_equal():
    np.testing.assert_array_equal(port_tables.ZIGZAG_ORDER,
                                  jax_tables.ZIGZAG_ORDER)
    np.testing.assert_array_equal(port_dct.dct_matrix(), jax_dct.dct_matrix())
    for n in ("SRGB_INV_OETF_N", "HLG_OETF_N", "HLG_INV_OETF_N", "PQ_OETF_N",
              "PQ_INV_OETF_N", "GAIN_FACTOR_N"):
        assert getattr(port_lut, n) == getattr(jax_lut, n)


def test_pack_luts_match_reference_tables():
    """The kernel's packed table holds code << 5 | length of the Annex K
    tables, as the TPU kernel's _packed_dc_lut/_packed_ac_lut do."""
    from libultrahdr_tpu.jpeg import device_entropy as jde
    from libultrahdr_tpu.jpeg import pack_kernel as jpk
    lut = port_pack.packed_luts()
    np.testing.assert_array_equal(lut[:12], jpk._packed_dc_lut(False))
    np.testing.assert_array_equal(lut[16:28], jpk._packed_dc_lut(True))
    assert not lut[12:16].any() and not lut[28:32].any()
    np.testing.assert_array_equal(lut[32:288], jde._packed_ac_lut(False))
    np.testing.assert_array_equal(lut[288:], jde._packed_ac_lut(True))


@pytest.mark.parametrize("name", [
    "K_SRGB", "K_P3", "K_BT2100", "SRGB_RGB2YUV", "SRGB_YUV2RGB",
    "P3_RGB2YUV", "P3_YUV2RGB", "BT2100_RGB2YUV", "BT2100_YUV2RGB",
    "BT709_TO_P3", "BT709_TO_BT2100", "P3_TO_BT709", "P3_TO_BT2100",
    "BT2100_TO_BT709", "BT2100_TO_P3"])
def test_colour_matrices_equal(name):
    np.testing.assert_array_equal(getattr(port_colors, name),
                                  getattr(jax_colors, name))


def test_colour_scalars_equal():
    for n in ("SDR_WHITE_NITS", "HLG_MAX_NITS", "PQ_MAX_NITS"):
        assert getattr(port_colors, n) == getattr(jax_colors, n)
    for ct in jax_types.ColorTransfer:
        assert port_colors.reference_display_peak_nits(int(ct)) == \
            jax_colors.reference_display_peak_nits(ct)


@pytest.mark.parametrize("sampling,gm_comment,dri", [
    ([(2, 2), (1, 1), (1, 1)], False, 17),
    ([(1, 1), (1, 1), (1, 1)], True, 9),
    ([(1, 1)], True, 0),
])
def test_assemble_jpeg_byte_identical(sampling, gm_comment, dri):
    rs = np.random.RandomState(len(sampling) + dri)
    scan = rs.randint(0, 256, 777, dtype=np.uint8).tobytes()
    ql = jax_tables.scaled_quant_table(jax_tables.STD_LUMA_QUANT, 90)
    qc = jax_tables.scaled_quant_table(jax_tables.STD_CHROMA_QUANT, 90)
    icc_j = jax_icc.write_icc_profile(jax_types.ColorTransfer.HLG,
                                      jax_types.ColorGamut.BT2100)
    icc_p = port_icc.write_icc_profile(port_types.ColorTransfer.HLG,
                                       port_types.ColorGamut.BT2100)
    assert icc_j == icc_p
    a = jax_encoder.assemble_jpeg(66, 130, sampling, ql, qc, scan, icc=icc_j,
                                  gainmap_comment=gm_comment, dri=dri)
    b = port_encoder.assemble_jpeg(66, 130, sampling, ql, qc, scan,
                                   icc=icc_p, gainmap_comment=gm_comment,
                                   dri=dri)
    assert a == b


@pytest.mark.parametrize("write_xmp,exif", [(False, None),
                                            (True, b"Exif\x00\x00MM\x00*"),
                                            (False, b"Exif\x00\x00II*\x00")])
def test_append_gainmap_byte_identical(write_xmp, exif):
    def md(types):
        m = types.GainMapMetadata()
        m.max_content_boost[:] = 1000.0 / 203.0
        m.gamma[:] = 1.571
        m.hdr_capacity_max = 4.5
        return m
    primary = b"\xFF\xD8" + bytes(range(200)) + b"\xFF\xD9"
    gainmap = b"\xFF\xD8" + bytes(range(100, 180)) + b"\xFF\xD9"
    a = jax_container.append_gainmap(primary, gainmap, md(jax_types),
                                     exif=exif, write_iso=True,
                                     write_xmp=write_xmp)
    b = port_container.append_gainmap(primary, gainmap, md(port_types),
                                      exif=exif, write_iso=True,
                                      write_xmp=write_xmp)
    assert a == b
    p, g, meta = testing.read_jpegr(
        port_container.append_gainmap(primary, gainmap, md(port_types)))
    assert g[-len(gainmap) + 2:] == gainmap[2:]
    np.testing.assert_allclose(meta.max_content_boost, 1000.0 / 203.0,
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [
    {},
    {"map_dimension_scale_factor": 4, "use_multi_channel_gainmap": False},
    {"map_dimension_scale_factor": 2, "gamma": 1.571,
     "map_compress_quality": 85, "target_disp_peak_brightness": 1000.0,
     "write_xmp": True},
])
def test_from_reference_knobs(kw):
    ref = jax_jpegr.JpegR(**kw)
    d = {k: getattr(ref, k) for k in port_jpegr.KNOBS}
    d = {k: (int(v) if k == "preset" else v) for k, v in d.items()}
    jr = port_jpegr.JpegR.from_reference_knobs(d, device="cpu")
    assert {k: getattr(jr, k) for k in port_jpegr.KNOBS} == d
    assert jr.device == torch.device("cpu")


def test_photo_p010_twin_equals_benchmarks():
    for w, h in ((130, 66), (64, 48), (700, 500)):
        a = benchmarks.photo_p010(w, h)
        b = testing.photo_p010(w, h)
        assert (a.w, a.h, int(a.fmt), int(a.cg), int(a.ct), int(a.range)) \
            == (b.w, b.h, int(b.fmt), int(b.cg), int(b.ct), int(b.range))
        for pa, pb in zip(a.planes, b.planes):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


def test_import_leaves_jax_out():
    """Importing the port (and every module of the slice) must not import
    jax or the JAX package."""
    code = ("import sys, libultrahdr_tpu_torch, libultrahdr_tpu_torch.fused, "
            "libultrahdr_tpu_torch.testing, libultrahdr_tpu_torch.api, "
            "libultrahdr_tpu_torch.jpegr, libultrahdr_tpu_torch.ops.apply, "
            "libultrahdr_tpu_torch.ops.apply_kernel, "
            "libultrahdr_tpu_torch.jpeg.decoder, "
            "libultrahdr_tpu_torch.container.segments, "
            "libultrahdr_tpu_torch.ops.effects_device, "
            "libultrahdr_tpu_torch.agtm, libultrahdr_tpu_torch.jpegr_compat, "
            "libultrahdr_tpu_torch.cli, libultrahdr_tpu_torch.capi_bridge, "
            "libultrahdr_tpu_torch.utils; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == 'libultrahdr_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _jax_package_paths(source: str) -> list[str]:
    """Expressions of a Python source that build a filesystem path into
    the JAX package: a ``/`` join, a path constructor or an os.path / glob
    / open call with a string component ``libultrahdr_tpu``."""
    import ast

    def into_jax(node):
        return isinstance(node, ast.Constant) and isinstance(
            node.value, str) and node.value.replace("\\", "/").strip(
            "./").split("/")[0] == "libultrahdr_tpu"
    path_calls = {"Path", "PurePath", "join", "joinpath", "open", "glob",
                  "rglob", "listdir", "exists", "is_file", "is_dir",
                  "abspath", "realpath", "CDLL"}
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and (into_jax(node.left) or into_jax(node.right)):
            found.append(ast.unparse(node))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in path_calls and any(into_jax(a) for a in node.args):
                found.append(ast.unparse(node))
    return found


NATIVE_SUFFIXES = (".c", ".cpp", ".cu", ".h", ".java")


def _jax_refs_in_native(source: str) -> list[str]:
    """The includes and string literals of a C, C++, CUDA, header or Java
    source that reach the JAX side: a module string of the JAX package
    (``"libultrahdr_tpu.<module>"``; the port's are
    ``"libultrahdr_tpu_torch.<module>"``) or a path into
    ``libultrahdr_tpu/``, ``capi/`` or ``java/`` (an entry of the JAX
    binding's directory, so a JNI class name such as ``java/io/...`` is
    none)."""
    import re
    java_entries = {f.name for f in (REPO / "java").iterdir()}
    found = []
    for m in re.finditer(r'^[ \t]*#[ \t]*include[ \t]*[<"]([^>"]+)[>"]'
                         r'|"((?:[^"\\\n]|\\.)*)"', source, re.M):
        text = m.group(1) if m.group(1) is not None else m.group(2)
        parts = [p for p in text.replace("\\", "/").split("/")
                 if p not in ("", ".", "..")]
        if ("libultrahdr_tpu." in text or "libultrahdr_tpu/" in text
                or "libultrahdr_tpu" in parts
                or parts[:1] == ["capi"] and len(parts) > 1
                or parts[:1] == ["java"] and len(parts) > 1
                and parts[1] in java_entries):
            found.append(m.group(0))
    return found


def test_import_guard_refuses_jax_references_in_native_sources():
    """The native-source half of the guard below refuses what would reach
    the JAX package from C, C++ or Java and passes the port's own."""
    for bad in ('g = PyImport_ImportModule("libultrahdr_tpu.capi_bridge");',
                '#include "../../capi/ultrahdr_tpu.h"',
                '#include <libultrahdr_tpu/jpeg/_native/jpeg_entropy.cpp>',
                'cmd = "-I" "../java/jni/stub";',
                'const char* p = "./libultrahdr_tpu/fused.py";',
                'String m = "libultrahdr_tpu.api";'):
        assert _jax_refs_in_native(bad), bad
    for good in ('g = PyImport_ImportModule("libultrahdr_tpu_torch.'
                 'capi_bridge");',
                 '#include "ultrahdr_tpu.h"', '#include <jni.h>',
                 'jclass c = env->FindClass("java/io/IOException");',
                 '// the JAX package (libultrahdr_tpu/fused.py) and capi/',
                 'System.loadLibrary("uhdr_tpu_torch_jni");'):
        assert not _jax_refs_in_native(good), good


def test_no_jax_import_in_port_sources():
    """No port module or root script of the port imports jax or the JAX
    package, or builds a filesystem path into the JAX package (the port
    keeps its own copies, the host C++ included); no port C, C++, CUDA,
    header or Java source reaches the JAX side (``_jax_refs_in_native``)."""
    scripts = [REPO / n for n in ("chip_smoke.py", "profile_decode.py",
                                  "profile_encode.py", "profile_throughput.py",
                                  "profile_variants.py")]
    for f in [*(REPO / "libultrahdr_tpu_torch").rglob("*.py"), *scripts]:
        text = f.read_text()
        for line in text.splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, s)
            assert "libultrahdr_tpu." not in s or not s.startswith(
                ("import", "from")), (f, s)
        assert not _jax_package_paths(text), (f, _jax_package_paths(text))
    native = [f for f in (REPO / "libultrahdr_tpu_torch").rglob("*")
              if f.suffix in NATIVE_SUFFIXES]
    assert {f.suffix for f in native} == set(NATIVE_SUFFIXES)
    for f in native:
        assert not _jax_refs_in_native(f.read_text()), (
            f, _jax_refs_in_native(f.read_text()))
    # the check refuses the path into the JAX C++ the port once compiled
    assert _jax_package_paths(
        'SRC = PKG_DIR.parent / "libultrahdr_tpu" / "jpeg" / "_native"')
    assert _jax_package_paths('os.path.join(ROOT, "libultrahdr_tpu/ops")')
    assert not _jax_package_paths('name = "libultrahdr_tpu/fused.py:1041"')


def test_cuda_request_without_gpu_raises(monkeypatch):
    """A CUDA device with no usable GPU raises, whether asked for or the
    default (the entry points run on the card unless the caller asks for the
    CPU); nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    knobs = {k: getattr(port.JpegR(device="cpu"), k) for k in
             port_jpegr.KNOBS}
    for make in (lambda: port.JpegR(device="cuda"),
                 lambda: port.UhdrEncoder(device="cuda"),
                 lambda: port.UhdrEncoder(device="cuda:0"),
                 lambda: port.UhdrDecoder(device="cuda"),
                 lambda: port.JpegR(device="cuda",
                                    preset=port.EncPreset.REALTIME),
                 lambda: port.JpegR.from_reference_knobs(knobs),
                 port.JpegR, port.UhdrEncoder, port.UhdrDecoder):
        with pytest.raises(port.UhdrError) as e:
            make()
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
    with pytest.raises(port.UhdrError):
        port_api.UhdrEncoder(device="meta")


def test_pack_dispatch_never_falls_back():
    """CPU tensors take the plain version; the kernel wrapper refuses CPU
    tensors, and a device without an implementation raises."""
    s = torch.zeros((4, 64), dtype=torch.int16)
    d = torch.zeros(4, dtype=torch.int32)
    lum = torch.ones(4, dtype=torch.int32)
    words, blen = port_pack.pack_scan(s, d, lum)
    np.testing.assert_array_equal(blen.numpy(), [6, 6, 6, 6])
    before = port_pack.PACK_KERNEL.launches
    with pytest.raises(ValueError):
        port_pack.PACK_KERNEL(s, d, lum)
    assert port_pack.PACK_KERNEL.launches == before
    with pytest.raises(port.UhdrError):
        port_pack.pack_scan(s.to("meta"), d.to("meta"), lum.to("meta"))
