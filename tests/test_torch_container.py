"""PyTorch port: the container layer's Apple gain-map metadata against the
JAX package, and a check that every relative import of the port resolves to
a module of the port.

An Apple-namespace XMP without ``HDRGainMapHeadroom`` takes its headroom
from the base image's EXIF MakerNote (``container/exif_apple.py``); both
packages must read the same metadata from it, or raise the same error."""

import ast
import pathlib
import struct

import numpy as np
import pytest

from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu.container import exif_apple as jax_exif
from libultrahdr_tpu.container import xmp as jax_xmp
from libultrahdr_tpu.errors import UhdrError as JaxUhdrError

from libultrahdr_tpu_torch import jpegr as port_jpegr
from libultrahdr_tpu_torch.container import xmp as port_xmp
from libultrahdr_tpu_torch.errors import UhdrError as PortUhdrError

from test_torch_jax_native import guard_jax_native

guard_jax_native()

PORT = pathlib.Path(__file__).resolve().parents[1] / "libultrahdr_tpu_torch"


def apple_exif(maker33=(2, 1), maker48=(1, 10), exif_header=True,
               little_endian_tiff=False) -> bytes:
    """EXIF with an "Apple iOS" MakerNote holding the signed rationals of
    tags 33 and 48 (as tests/test_container.py builds it): a TIFF header,
    IFD0 with the MakerNote tag, the MakerNote header and its IFD.  The
    MakerNote is big-endian whatever the TIFF's byte order."""
    e = "<" if little_endian_tiff else ">"
    apple = jax_exif.APPLE_MAKER_HEADER
    tiff = bytearray(b"II\x2a\x00" if little_endian_tiff else b"MM\x00\x2a")
    tiff += struct.pack(e + "I", 8)
    makernote_offset = 8 + 2 + 12 + 4
    tiff += struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHII", 0x927C, 7, 1, makernote_offset)
    tiff += struct.pack(e + "I", 0)
    mk = bytearray(apple)
    ifd_off = makernote_offset + len(apple)
    base = ifd_off - len(apple)
    value_area = ifd_off + 2 + 2 * 12 + 4
    mk += struct.pack(">H", 2)
    mk += struct.pack(">HHII", 33, 10, 1, value_area - base)
    mk += struct.pack(">HHII", 48, 10, 1, value_area - base + 8)
    mk += struct.pack(">I", 0)
    mk += struct.pack(">iI", *maker33)
    mk += struct.pack(">iI", *maker48)
    tiff += mk
    return (b"Exif\x00\x00" if exif_header else b"") + bytes(tiff)


def apple_xmp(headroom: bytes | None = None) -> bytes:
    """An Apple-namespace XMP packet (HDRGainMap element content), with or
    without HDRGainMapHeadroom."""
    body = (b"<rdf:Description><HDRGainMap:HDRGainMapVersion>65536"
            b"</HDRGainMap:HDRGainMapVersion>")
    if headroom is not None:
        body += (b"<HDRGainMap:HDRGainMapHeadroom>" + headroom
                 + b"</HDRGainMap:HDRGainMapHeadroom>")
    body += b"</rdf:Description>"
    return jax_xmp.XMP_NAMESPACE.encode() + b"\x00" + body


METADATA_FIELDS = ("max_content_boost", "min_content_boost", "gamma",
                   "offset_sdr", "offset_hdr", "hdr_capacity_min",
                   "hdr_capacity_max", "use_base_cg")

# (maker33, maker48) across the four branches of Apple's stops formula,
# a zero denominator (no value: no headroom), and the two TIFF byte orders
# with and without the "Exif\0\0" prefix
EXIFS = {
    "33>=1, 48>0.01": apple_exif((2, 1), (1, 10)),
    "33>=1, 48<=0.01": apple_exif((3, 2), (1, 200)),
    "33<1, 48>0.01": apple_exif((1, 2), (7, 10)),
    "33<1, 48<=0.01": apple_exif((1, 4), (-1, 100)),
    "little-endian TIFF": apple_exif(little_endian_tiff=True),
    "no Exif prefix": apple_exif(exif_header=False),
    "zero denominators": apple_exif((2, 0), (1, 0)),
    "truncated": apple_exif()[:40],
}


@pytest.mark.parametrize("name", list(EXIFS))
def test_exif_apple_headroom_matches_jax(name):
    """The port's get_exif_apple_headroom returns the JAX package's value
    (or None) on every MakerNote case."""
    from libultrahdr_tpu_torch.container import exif_apple as port_exif
    exif = EXIFS[name]
    got = port_exif.get_exif_apple_headroom(exif)
    want = jax_exif.get_exif_apple_headroom(exif)
    assert got == want
    assert port_exif.APPLE_MAKER_HEADER == jax_exif.APPLE_MAKER_HEADER
    if name == "33>=1, 48>0.01":
        assert got == pytest.approx(2.0 ** (-0.303 * 0.1 + 2.303), rel=1e-6)


def _outcome(parse, error_type):
    """(metadata fields as numpy arrays, None) or (None, error code)."""
    try:
        md = parse()
    except error_type as e:
        return None, int(e.code)
    return {f: np.asarray(getattr(md, f)) for f in METADATA_FIELDS}, None


@pytest.mark.parametrize("name", list(EXIFS))
def test_apple_xmp_headroom_from_exif_matches_jax(name):
    """An Apple XMP without HDRGainMapHeadroom and with base EXIF: the
    port's parse_xmp_metadata and JpegR.parse_gainmap_metadata (the decode
    and probe route to it) give the JAX package's metadata, or raise its
    error code where the MakerNote holds no headroom."""
    exif, payload = EXIFS[name], apple_xmp()
    for port_parse, jax_parse in (
            (lambda: port_xmp.parse_xmp_metadata(payload, exif),
             lambda: jax_xmp.parse_xmp_metadata(payload, exif)),
            (lambda: port_jpegr.JpegR(device="cpu").parse_gainmap_metadata(
                None, payload, exif),
             lambda: jax_jpegr.JpegR().parse_gainmap_metadata(
                 None, payload, exif))):
        got, got_err = _outcome(port_parse, PortUhdrError)
        want, want_err = _outcome(jax_parse, JaxUhdrError)
        assert got_err == want_err
        if want is None:
            continue
        assert got.keys() == want.keys()
        for f in METADATA_FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if name == "33>=1, 48>0.01":
        assert got["hdr_capacity_max"] == pytest.approx(
            2.0 ** (-0.303 * 0.1 + 2.303), rel=1e-6)


@pytest.mark.parametrize("headroom", [b"3.0", b"not a number"])
def test_apple_xmp_headroom_element_matches_jax(headroom):
    """HDRGainMapHeadroom present: read from the XMP (EXIF ignored); an
    unparseable value falls through to the MakerNote in both packages."""
    exif, payload = apple_exif(), apple_xmp(headroom)
    got = port_xmp.parse_xmp_metadata(payload, exif)
    want = jax_xmp.parse_xmp_metadata(payload, exif)
    for f in METADATA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _module_names(pkg_dir: pathlib.Path) -> set[str]:
    """Top-level names a package's __init__.py binds (assignments,
    definitions and imports)."""
    init = pkg_dir / "__init__.py"
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


def unresolved_relative_imports(root: pathlib.Path) -> list[str]:
    """Every relative import under the package `root` that does not name a
    module of that package: ``from .a.b import c`` needs ``a/b.py`` or
    ``a/b/__init__.py`` below the importing file's package, without
    climbing out of `root`; ``from . import c`` needs ``c`` to be a
    submodule or a name bound in the package's __init__.py."""
    bad = []
    for f in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if not isinstance(node, ast.ImportFrom) or not node.level:
                continue
            where = f"{f.relative_to(root.parent)}:{node.lineno}"
            pkg = f.parent
            for _ in range(node.level - 1):
                pkg = pkg.parent
            if root not in (pkg, *pkg.parents):
                bad.append(f"{where}: climbs out of {root.name}")
                continue
            parts = node.module.split(".") if node.module else []
            target = pkg.joinpath(*parts)
            if parts and not (target.with_suffix(".py").is_file()
                              or (target / "__init__.py").is_file()):
                bad.append(f"{where}: no module {'.' * node.level}"
                           f"{node.module}")
                continue
            if parts:
                continue
            bound = _module_names(pkg)
            for a in node.names:
                sub = pkg / a.name
                if not (sub.with_suffix(".py").is_file()
                        or (sub / "__init__.py").is_file()
                        or a.name in bound):
                    bad.append(f"{where}: no module {'.' * node.level}"
                               f"{a.name}")
    return bad


def test_every_relative_import_of_the_port_resolves():
    """Every relative import in libultrahdr_tpu_torch/ names a module of the
    port (container/xmp.py imports .exif_apple, which the port once
    lacked)."""
    assert unresolved_relative_imports(PORT) == []


def test_relative_import_check_finds_a_missing_module(tmp_path):
    """The check refuses an import of a module the package lacks, one that
    climbs out of the package, and a name its __init__ does not bind."""
    pkg = tmp_path / "pkg"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("from . import sub\nX = 1\n")
    (pkg / "sub" / "__init__.py").write_text("")
    (pkg / "sub" / "a.py").write_text(
        "from .b import f\nfrom ..sub import a\nfrom ... import y\n"
        "from .. import X, sub, Z\n")
    assert unresolved_relative_imports(pkg) == [
        "pkg/sub/a.py:1: no module .b",
        "pkg/sub/a.py:3: climbs out of pkg",
        "pkg/sub/a.py:4: no module ..Z"]
