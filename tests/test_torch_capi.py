"""PyTorch port: the C ABI (libultrahdr_tpu_torch/capi/) against the Python
API and the JAX package, on the CPU (``UHDR_TPU_TORCH_DEVICE=cpu``).

- ``ultrahdr_tpu.h`` declares the JAX package's ABI: below its header
  comment the same text, and one C source compiled against both prints the
  same struct sizes, field offsets and enum values.
- The reference walkthrough ``test_capi.c`` exits 0.
- ``capi_roundtrip`` on a seeded ``testing.photo_p010`` of 128x96 in both
  configurations (map scale 4, one channel; scale 1, three): its file is
  byte-equal to ``UhdrEncoder(device="cpu").encode()``, its HLG and LINEAR
  decodes to ``UhdrDecoder(device="cpu")``'s; two C threads, each through
  its own encoder, write the sequential file (``capi_roundtrip``'s own
  check).  Their first encodes ran the process's first calls of MKL's
  vector math on several threads at once, which could run a share of
  ``torch.exp`` on another code path and change the bytes (ROADMAP F2): the
  package's import makes that first call
  (``test_import_settles_the_cpu_math_path``).  Against the JAX package's
  ``UhdrEncoder().encode()`` of the same numpy planes, the contract of
  test_torch_encode.py: coefficients at most 1 apart (rounding ties), a
  scan byte-equal where its coefficients agree and the file where they all
  do, the JAX decoder's HLG decode of it
  within 60 dB PSNR of its decode of the JAX file; the C decodes within
  ``testing.check_decoded_close`` of the JAX decoder's of the same file.
- Through the shim loaded into this interpreter (``abi.load``): the same
  files and decodes, also from two Python threads; invalid raw images and a
  truncated stream give the codes the JAX bridge's ``error_tuple`` gives.
- With the variable unset and no GPU, ``uhdr_create_encoder`` and
  ``uhdr_create_decoder`` return NULL: nothing falls back to the CPU.
- The shim linked against libpython works when a host loads it with
  ``dlopen(RTLD_LOCAL)``, as a JVM loads the JNI binding; the one for
  ``ctypes.CDLL`` links no libpython; an exception inside ``uhdr_encode`` /
  ``uhdr_decode`` (a CUDA error on the card) comes back as a non-OK
  ``uhdr_error_info_t``.
"""

import ctypes
import functools
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import capi_bridge as jax_bridge
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.errors import UhdrError as JaxUhdrError

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.capi import abi, build

from test_torch_jax_native import guard_jax_native

guard_jax_native()

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 128, 96
CONFIGS = {"benchmark": dict(scale=4, multichannel=False),
           "default": dict(scale=1, multichannel=True)}
Fmt, CT = port.ImgFmt, port.ColorTransfer
OUTS = ((Fmt.RGBA1010102, CT.HLG, "hlg"), (Fmt.RGBAF16, CT.LINEAR, "linear"))


def _cpu_env():
    return build.embed_env() | {"UHDR_TPU_TORCH_DEVICE": "cpu"}


def _planes():
    img = testing.photo_p010(W, H)
    return img, [np.ascontiguousarray(p, np.uint16) for p in img.planes[:2]]


@functools.lru_cache(maxsize=None)
def _python_api(cfg):
    """The port's Python API on the CPU: (file, {ct: decoded bytes})."""
    img, _ = _planes()
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(img, port.ImgLabel.HDR)
    enc.set_gainmap_scale_factor(CONFIGS[cfg]["scale"])
    enc.set_using_multi_channel_gainmap(CONFIGS[cfg]["multichannel"])
    enc.set_quality(95, port.ImgLabel.BASE)
    data = enc.encode()
    decoded = {}
    for fmt, ct, _ in OUTS:
        dec = port.UhdrDecoder(device="cpu")
        dec.set_image(data)
        dec.set_out_img_format(fmt)
        dec.set_out_color_transfer(ct)
        decoded[ct] = dec.decode().planes[0]
    return data, decoded


@functools.lru_cache(maxsize=None)
def _jax_file(cfg):
    _, (y, uv) = _planes()
    enc = jax_api.UhdrEncoder()
    enc.set_raw_image(jax_types.RawImage(
        jax_types.ImgFmt.P010, jax_types.ColorGamut.BT2100,
        jax_types.ColorTransfer.HLG, jax_types.ColorRange.FULL, W, H,
        [y, uv]), jax_types.ImgLabel.HDR)
    enc.set_gainmap_scale_factor(CONFIGS[cfg]["scale"])
    enc.set_using_multi_channel_gainmap(CONFIGS[cfg]["multichannel"])
    enc.set_quality(95, jax_types.ImgLabel.BASE)
    return enc.encode()


def _jax_decode(data, fmt, ct):
    dec = jax_api.UhdrDecoder()
    dec.set_image(data)
    dec.set_out_img_format(jax_types.ImgFmt(int(fmt)))
    dec.set_out_color_transfer(jax_types.ColorTransfer(int(ct)))
    return np.asarray(dec.decode().planes[0])


@pytest.fixture(scope="module")
def programs():
    shim = build.build_shim(linked=True)
    return {"shim": shim,
            "test_capi": build.build_program("test_capi", shim),
            "capi_roundtrip": build.build_program("capi_roundtrip", shim)}


@pytest.fixture(scope="module")
def inproc():
    return abi.load(build.build_shim(linked=False))


@pytest.fixture(scope="module", params=list(CONFIGS))
def roundtrip(request, programs, tmp_path_factory):
    """capi_roundtrip of one configuration with two threads on the CPU."""
    cfg = request.param
    d = tmp_path_factory.mktemp(f"roundtrip_{cfg}")
    _, (y, uv) = _planes()
    (d / "in.p010").write_bytes(y.tobytes() + uv.tobytes())
    kw = CONFIGS[cfg]
    r = subprocess.run(
        [str(programs["capi_roundtrip"]), str(d / "in.p010"), str(W), str(H),
         str(kw["scale"]), str(int(kw["multichannel"])), "95", str(d / "o"),
         "2"], env=_cpu_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    raw = {ct: np.fromfile(d / f"o.{tag}.raw",
                           np.uint32 if fmt == Fmt.RGBA1010102 else np.uint16)
           for fmt, ct, tag in OUTS}
    return dict(cfg=cfg, dir=d, stdout=r.stdout,
                file=(d / "o.jpg").read_bytes(),
                decoded={CT.HLG: raw[CT.HLG].reshape(H, W),
                         CT.LINEAR: raw[CT.LINEAR].reshape(H, W, 4)})


def _c_enum_members(header: str) -> list[str]:
    return [m.split("=")[0].strip()
            for body in re.findall(r"typedef enum \w+ \{(.*?)\}", header, re.S)
            for m in body.split(",") if m.strip()]


def test_header_declares_the_jax_abi(tmp_path):
    jax_h = (REPO / "capi" / "ultrahdr_tpu.h").read_text()
    port_h = build.HEADER.read_text()
    assert port_h.split("*/", 1)[1] == jax_h.split("*/", 1)[1]
    structs = {
        "uhdr_error_info_t": ["error_code", "has_detail", "detail"],
        "uhdr_raw_image_t": ["fmt", "cg", "ct", "range", "w", "h", "planes",
                             "stride"],
        "uhdr_compressed_image_t": ["data", "data_sz", "capacity", "cg", "ct",
                                    "range"],
        "uhdr_mem_block_t": ["data", "data_sz", "capacity"],
        "uhdr_gainmap_metadata_t": [
            "max_content_boost", "min_content_boost", "gamma", "offset_sdr",
            "offset_hdr", "hdr_capacity_min", "hdr_capacity_max",
            "use_base_cg"]}
    lines = [f'printf("{t} %zu\\n", sizeof({t}));' for t in structs] + [
        f'printf("{t}.{f} %zu\\n", offsetof({t}, {f}));'
        for t, fields in structs.items() for f in fields] + [
        f'printf("{m} %d\\n", (int){m});' for m in _c_enum_members(jax_h)] + [
        'printf("version %d %s\\n", UHDR_LIB_VERSION, UHDR_LIB_VERSION_STR);']
    assert len(_c_enum_members(jax_h)) == 45
    src = tmp_path / "abi.c"
    src.write_text("#include <stddef.h>\n#include <stdio.h>\n"
                   '#include "ultrahdr_tpu.h"\nint main(void) {\n  '
                   + "\n  ".join(lines) + "\n  return 0;\n}\n")
    out = {}
    for tag, inc in (("jax", REPO / "capi"), ("port", build.CAPI_DIR)):
        exe = tmp_path / f"abi_{tag}"
        subprocess.run(["gcc", "-Wall", "-Werror", f"-I{inc}", str(src), "-o",
                        str(exe)], check=True)
        out[tag] = subprocess.run([str(exe)], check=True, capture_output=True,
                                  text=True).stdout
    assert out["port"] == out["jax"]
    assert "uhdr_raw_image_t 64" in out["port"]


def test_walkthrough_on_the_cpu(programs):
    r = subprocess.run([str(programs["test_capi"])], env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "capi round-trip OK" in r.stdout


def test_roundtrip_equals_the_python_api(roundtrip):
    data, decoded = _python_api(roundtrip["cfg"])
    assert roundtrip["file"] == data
    for _, ct, _ in OUTS:
        np.testing.assert_array_equal(roundtrip["decoded"][ct], decoded[ct])
    steps = re.findall(r"^ms (\S+) [0-9.]+$", roundtrip["stdout"], re.M)
    for step in ("init", "create_encoder", "create_decoder", "encode",
                 "encode.uhdr_encode", "decode_hlg", "decode_hlg.uhdr_decode",
                 "decode_linear"):
        assert step in steps, step


def test_c_threads_write_the_sequential_file(roundtrip):
    assert "threads: 2 files equal the sequential one" in roundtrip["stdout"]
    for i in range(2):
        assert (roundtrip["dir"] / f"o.t{i}.jpg").read_bytes() == \
            roundtrip["file"]


# A fresh process: with "import" it imports the bridge (what the C ABI's
# shim imports first) and only then asks MKL for its SSE4.2 path, which MKL
# reads at the first call of its vector math; else it makes that first call
# itself on one element (so that no two threads make it); prints a digest
# of torch.exp over a fixed float32 ramp
_MATH_PATH = """
import hashlib, os, sys
import numpy as np
import torch
if sys.argv[1] == "import":
    import libultrahdr_tpu_torch.capi_bridge
    os.environ["MKL_ENABLE_INSTRUCTIONS"] = "SSE4_2"
else:
    torch.exp(torch.zeros(1))
x = torch.from_numpy(np.linspace(-4.0, 4.0, 36864, dtype=np.float32))
print(hashlib.sha256(torch.exp(x).numpy().tobytes()).hexdigest())
"""


def _math_path(how: str, **env) -> str:
    base = {k: v for k, v in os.environ.items()
            if k != "MKL_ENABLE_INSTRUCTIONS"}
    return subprocess.run([sys.executable, "-c", _MATH_PATH, how],
                          cwd=REPO, env=base | env, capture_output=True,
                          text=True, check=True, timeout=120).stdout


def test_import_settles_the_cpu_math_path():
    """F2's cause, shown without relying on the race: MKL chooses its
    vector math's code path at the first call, and two threads making that
    first call together could run a share of the elements on another path
    (other rounding), so two concurrent first encodes wrote different
    bytes.  After the package's import the choice is made: asking MKL for
    another path then changes nothing, while the same request before the
    first call does (the probe sees the path)."""
    assert torch.backends.mkl.is_available()
    default = _math_path("plain")
    assert _math_path("plain", MKL_ENABLE_INSTRUCTIONS="SSE4_2") != default
    assert _math_path("import") == default


def _layouts(cfg):
    kw = CONFIGS[cfg]
    gm = (port_fused._SAMPLING_444 if kw["multichannel"]
          else port_fused._SAMPLING_400)
    return [port_fused._layout_for(H, W, port_fused._SAMPLING_420),
            port_fused._layout_for(H // kw["scale"], W // kw["scale"], gm)]


def test_roundtrip_holds_against_jax(roundtrip, monkeypatch):
    monkeypatch.setenv("UHDR_TPU_DECODE_ENGINE", "device")
    cfg, got = roundtrip["cfg"], roundtrip["file"]
    want = _jax_file(cfg)
    agree = True
    for part, layout in enumerate(_layouts(cfg)):
        gc = testing.decode_scan_coeffs(testing.read_jpegr(got)[part], layout)
        wc = testing.decode_scan_coeffs(testing.read_jpegr(want)[part],
                                        layout)
        diff = np.concatenate([np.abs(a.astype(np.int32) - b).ravel()
                               for a, b in zip(gc, wc)])
        assert diff.max() <= 1
        if not diff.any():
            assert testing.scan_data(testing.read_jpegr(got)[part]) == \
                testing.scan_data(testing.read_jpegr(want)[part])
        agree &= not diff.any()
    if agree:
        assert got == want
    codes = [testing.codes_1010102(_jax_decode(d, Fmt.RGBA1010102, CT.HLG))
             for d in (got, want)]
    mse = np.mean((codes[0] - codes[1]).astype(np.float64) ** 2)
    assert mse == 0 or 10 * np.log10(1023.0 ** 2 / mse) >= 60.0
    for fmt, ct, tag in OUTS:
        testing.check_decoded_close(roundtrip["decoded"][ct],
                                    _jax_decode(got, fmt, ct), ct,
                                    f"{cfg} {tag}")


def test_in_process_shim_equals_the_python_api(inproc, monkeypatch):
    """ctypes.CDLL of the shim built without libpython, from this
    interpreter and from two threads at once, each with its own handles."""
    monkeypatch.setenv("UHDR_TPU_TORCH_DEVICE", "cpu")
    _, (y, uv) = _planes()
    for cfg, kw in CONFIGS.items():
        data, decoded = _python_api(cfg)
        assert abi.encode_p010(inproc, y, uv, **kw) == data
        for fmt, ct, _ in OUTS:
            np.testing.assert_array_equal(abi.decode(inproc, data, fmt, ct),
                                          decoded[ct])
    got = [None, None]

    def run(i):
        got[i] = abi.encode_p010(inproc, y, uv, **CONFIGS["benchmark"])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert got == [_python_api("benchmark")[0]] * 2


def test_shim_variants(programs):
    """The stand-alone variant needs libpython; the one for ctypes.CDLL
    does not, so a running interpreter loads no second libpython."""
    needed = {linked: subprocess.run(
        ["readelf", "-d", str(build.build_shim(linked=linked))], check=True,
        capture_output=True, text=True).stdout for linked in (True, False)}
    assert "libpython" in needed[True] and "libpython" not in needed[False]


def test_engine_errors_come_back_as_error_info(inproc, monkeypatch):
    """An exception raised inside uhdr_encode / uhdr_decode (a CUDA error
    on the card) returns a non-OK uhdr_error_info_t carrying its text; the
    process goes on."""
    monkeypatch.setenv("UHDR_TPU_TORCH_DEVICE", "cpu")

    def fail(self):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(port.UhdrEncoder, "encode", fail)
    monkeypatch.setattr(port.UhdrDecoder, "decode", fail)
    _, (y, uv) = _planes()
    with pytest.raises(port.UhdrError) as e:
        abi.encode_p010(inproc, y, uv, **CONFIGS["benchmark"])
    with pytest.raises(port.UhdrError) as d:
        abi.decode(inproc, _python_api("benchmark")[0], Fmt.RGBA1010102,
                   CT.HLG)
    for err, call in ((e, "uhdr_encode"), (d, "uhdr_decode")):
        assert err.value.code == port.UhdrErrorCode.UHDR_CODEC_UNKNOWN_ERROR
        assert err.value.detail.startswith(call)
        assert "CUDA error: an illegal memory access" in err.value.detail


def _c_raw_image(fmt, ct, w, h, addrs, strides):
    return abi.RawImage(int(fmt), int(port.ColorGamut.BT2100), int(ct),
                        int(port.ColorRange.FULL), w, h,
                        (ctypes.c_void_p * 3)(*addrs),
                        (ctypes.c_uint * 3)(*strides))


def test_error_codes_match_the_jax_bridge(inproc, monkeypatch):
    """Each refusal of the shim carries the code the JAX bridge's
    error_tuple gives the same call."""
    monkeypatch.setenv("UHDR_TPU_TORCH_DEVICE", "cpu")
    _, (y, uv) = _planes()
    yp, uvp = y.ctypes.data, uv.ctypes.data
    cases = {   # (fmt, ct, w, h, plane addresses, strides)
        "null plane": (Fmt.P010, CT.HLG, W, H, (yp, 0, 0), (W, W, 0)),
        "stride < width": (Fmt.P010, CT.HLG, W, H, (yp, uvp, 0),
                           (W - 2, W, 0)),
        "odd width": (Fmt.P010, CT.HLG, W - 1, H, (yp, uvp, 0), (W, W, 0)),
        "SRGB HDR": (Fmt.P010, CT.SRGB, W, H, (yp, uvp, 0), (W, W, 0)),
        "unknown format": (99, CT.HLG, W, H, (yp, uvp, 0), (W, W, 0)),
    }
    for what, (fmt, ct, w, h, addrs, strides) in cases.items():
        enc = inproc.uhdr_create_encoder()
        assert enc
        img = _c_raw_image(fmt, ct, w, h, addrs, strides)
        err = inproc.uhdr_enc_set_raw_image(enc, ctypes.byref(img),
                                            int(port.ImgLabel.HDR))
        inproc.uhdr_release_encoder(enc)
        with pytest.raises(Exception) as e:
            jax_bridge.enc_set_raw_image(
                jax_bridge.enc_new(), int(fmt), int(port.ColorGamut.BT2100),
                int(ct), int(port.ColorRange.FULL), w, h, list(addrs),
                list(strides), int(port.ImgLabel.HDR))
        code = jax_bridge.error_tuple(e.value)[0]
        assert code != port.UhdrErrorCode.UHDR_CODEC_OK, what
        assert err.error_code == code, (what, err.error_code, code,
                                        err.detail)

    data = _python_api("benchmark")[0]
    for cut in (len(data) // 2, 100):
        truncated = data[:cut]
        with pytest.raises(port.UhdrError) as e:
            abi.decode(inproc, truncated, Fmt.RGBA1010102, CT.HLG)
        jdec = jax_bridge.dec_new()
        with pytest.raises(JaxUhdrError) as je:
            jax_bridge.dec_set_image(jdec, truncated)
            jdec.set_out_img_format(int(Fmt.RGBA1010102))
            jdec.set_out_color_transfer(int(CT.HLG))
            jdec.decode()
        assert int(e.value.code) == jax_bridge.error_tuple(je.value)[0]


def test_no_gpu_no_codec(programs, inproc, monkeypatch, tmp_path):
    """UHDR_TPU_TORCH_DEVICE unset means the card; with no GPU both
    constructors return NULL, from a C program and in process, and print
    the UhdrError."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card is the default")
    monkeypatch.delenv("UHDR_TPU_TORCH_DEVICE", raising=False)
    assert not inproc.uhdr_create_encoder()
    assert not inproc.uhdr_create_decoder()
    env = build.embed_env()
    env.pop("UHDR_TPU_TORCH_DEVICE", None)
    _, (y, uv) = _planes()
    (tmp_path / "in.p010").write_bytes(y.tobytes() + uv.tobytes())
    r = subprocess.run(
        [str(programs["capi_roundtrip"]), str(tmp_path / "in.p010"), str(W),
         str(H), "4", "0", "95", str(tmp_path / "o")], env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "uhdr_create_encoder uhdr_create_decoder returned NULL" in r.stderr
    assert r.stderr.count("UHDR_CODEC_UNSUPPORTED_FEATURE") == 2
    assert not list(tmp_path.glob("o*"))


def test_shim_loads_with_dlopen_local(programs, tmp_path):
    """A host that dlopens the shim with RTLD_LOCAL (a JVM loading the JNI
    binding) gets a codec: the extension modules torch and numpy load find
    libpython's symbols."""
    src = tmp_path / "loader.c"
    src.write_text(r'''
#include <dlfcn.h>
#include <stdio.h>
int main(int argc, char** argv) {
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_LOCAL);
  if (!lib) { fprintf(stderr, "%s\n", dlerror()); return 3; }
  void* (*create)(void) = (void* (*)(void))dlsym(lib, "uhdr_create_encoder");
  void (*release)(void*) = (void (*)(void*))dlsym(lib, "uhdr_release_encoder");
  void* enc = create ? create() : NULL;
  if (!enc) return 1;
  release(enc);
  printf("encoder created\n");
  return 0;
}
''')
    exe = tmp_path / "loader"
    subprocess.run(["gcc", str(src), "-o", str(exe), "-ldl"], check=True)
    r = subprocess.run([str(exe), str(programs["shim"])], env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "encoder created" in r.stdout
