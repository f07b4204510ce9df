"""ASan/UBSan gate for the port's host C++ and its C-ABI shim.

    python -m libultrahdr_tpu_torch.tools.sanitize_replay

The port's hand-written host code is the entropy codec and the host decode
engine (``csrc/host/jpeg_entropy.cpp``, ``host_decode.cpp``, bound in
``jpeg/native.py``) and the C ABI shim (``capi/uhdr_capi.cpp``).  This
tool:

1. re-runs itself with ``LD_PRELOAD=libasan`` and ``UHDR_TPU_SANITIZE=1``,
   so that the host library is built and loaded as ``jpeg_entropy_asan``
   (``-O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all``): a
   finding aborts the process and the gate fails;
2. replays the committed corpus (``fuzz/corpus/``, every file through
   every target) through the port's parsers and its ctypes natives: the
   segment scanner, the ISO / XMP / ICC parsers, the JPEG header parse,
   the probe, the baseline ``decode_scan``, the progressive decode and the
   host decode engine (``JpegR.decode_host``);
3. drives the encode-side natives and the other bound ones with seeded
   adversarial inputs: ``encode_scan`` (round-tripped through
   ``decode_scan``, and refusing uncodable coefficients), ``join_blocks``,
   ``uhdr_stuff_scan`` and ``uhdr_stuff_scan_ranges`` (called through the
   library itself: they have no binding), ``pack_p010_10bit``,
   ``pack_delta7``, ``pack_delta_g_into``, ``pack_vw_into``,
   ``pack_slices_into``, ``unpack_delta2d``, ``extract_channel10``,
   ``idct_plane``, ``ycbcr_to_rgb_planar``, ``ycbcr_to_rgb888``,
   ``ycc_to_rgba32`` and ``apply_gainmap_host``;
4. builds the shim and its C programs with ``UHDR_CAPI_SANITIZE=1`` and
   runs ``capi_asan_smoke.c`` (the marshaling of invalid arguments),
   ``test_capi.c`` and ``capi_roundtrip`` (one encode from two threads and
   two decodes) on the CPU (``UHDR_TPU_TORCH_DEVICE=cpu``), the embedded
   interpreter loading the sanitized host library too.

Limit: under a preloaded ASan runtime any C++ exception that libtorch
throws aborts the process (ASan's ``__cxa_throw`` interceptor check
fails), so the replay drives only paths on which torch raises nothing:
the parsers raise ``UhdrError`` in Python and the natives are called
through ctypes.  The C programs embed Python and import torch under the
same limit.

Exit 0: no sanitizer finding; "SANITIZE REPLAY OK" is the last line.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
REPO = PKG_DIR.parent
_CHILD = "_UHDR_TORCH_SAN_CHILD"
SAN_ENV = {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "halt_on_error=1:abort_on_error=1:"
                            "print_stacktrace=1"}


def find_libasan() -> str | None:
    """The compiler's libasan.so, or None."""
    try:
        p = subprocess.run(["g++", "-print-file-name=libasan.so"],
                           capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    path = p.stdout.strip()
    return path if path and os.path.isabs(path) and os.path.exists(path) \
        else None


def reexec_sanitized() -> int:
    asan = find_libasan()
    if asan is None:
        print("sanitize_replay: no libasan.so for g++ on this host",
              file=sys.stderr)
        return 2
    env = dict(os.environ, **SAN_ENV)
    env["LD_PRELOAD"] = os.path.realpath(asan)
    env["UHDR_TPU_SANITIZE"] = "1"
    env[_CHILD] = "1"
    return subprocess.run(
        [sys.executable, "-m", "libultrahdr_tpu_torch.tools.sanitize_replay"]
        + sys.argv[1:], env=env, cwd=REPO).returncode


# ---------------------------------------------------------------------------
# step 2: the corpus through the parsers and the natives

def decode_coeffs_native(data: bytes, jr=None):
    """The decode's host front half: the header parse and the baseline or
    progressive coefficient decode, no IDCT (images of at most
    ``MAX_DECODE_PIXELS``)."""
    from ..fuzz.fuzz_parsers import MAX_DECODE_PIXELS
    from ..jpeg import decoder
    info = decoder.parse_jpeg(data)
    if info.width * info.height > MAX_DECODE_PIXELS:
        return None
    return decoder.decode_coefficients(data, info)


def decode_host_native(data: bytes, jr):
    """The host decode engine: Huffman, AAN IDCT and the fused apply in the
    host C++, to HLG and to LINEAR."""
    from ..types import ColorTransfer
    return [jr.decode_host(data, output_ct=ct)
            for ct in (ColorTransfer.HLG, ColorTransfer.LINEAR)]


def replay_targets() -> dict:
    """The fuzzer's targets with jpeg_decode on the natives alone, and the
    host decode engine."""
    from ..fuzz.fuzz_parsers import TARGETS
    targets = dict(TARGETS)
    targets["jpeg_decode"] = decode_coeffs_native
    targets["host_decode"] = decode_host_native
    return targets


def replay_corpus() -> int:
    """Every committed corpus file through every target (a target's own
    files and the others'); returns the pairs replayed."""
    from ..fuzz.fuzz_parsers import CLEAN, CORPUS
    from ..jpegr import JpegR
    jr = JpegR(device="cpu")
    files = [f for d in sorted(CORPUS.iterdir()) if d.is_dir()
             for f in sorted(d.iterdir())]
    n = 0
    for name, target in replay_targets().items():
        for f in files:
            try:
                target(f.read_bytes(), jr)
            except CLEAN:
                pass
            n += 1
    print(f"replayed {n} corpus-target pairs ({len(files)} files) under "
          "ASan/UBSan", flush=True)
    return n


# ---------------------------------------------------------------------------
# step 3: the other natives on adversarial inputs

def _raw_fn(name: str, restype, argtypes):
    """A library entry point with no binding in ``jpeg/native.py``, as a
    function object of its own (the library's are left as they are)."""
    from ..jpeg import native
    return ctypes.CFUNCTYPE(restype, *argtypes)((name, native.get_lib()))


def _encode_and_decode(rs, trial: int):
    import numpy as np
    from ..jpeg import native
    from ..jpeg.tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA
    dc_tables = [DC_LUMA, DC_CHROMA, None, None]
    ac_tables = [AC_LUMA, AC_CHROMA, None, None]
    mw, mh = int(rs.randint(1, 9)), int(rs.randint(1, 9))
    # extreme codable coefficients: AC over the full +-1023, dense runs
    comps = []
    for ci, (hs, vs) in enumerate([(2, 2), (1, 1), (1, 1)]):
        c = rs.randint(-1023, 1024, (mh * vs, mw * hs, 64)).astype(np.int16)
        if trial % 2:
            c[..., 1:] *= (rs.rand(*c[..., 1:].shape) < 0.1)
        comps.append({"coeffs": c, "h": hs, "v": vs,
                      "dc_tbl": min(ci, 1), "ac_tbl": min(ci, 1)})
    restart = mw if trial % 3 else 0
    scan = native.encode_scan(comps, mw, mh, dc_tables, ac_tables,
                              restart_interval=restart)
    assert len(scan) > 0
    dcomps = [{k: c[k] for k in ("h", "v", "dc_tbl", "ac_tbl")}
              for c in comps]
    out, _ = native.decode_scan(scan, dcomps, mw, mh, dc_tables, ac_tables,
                                restart)
    for arr, c in zip(out, comps):
        np.testing.assert_array_equal(arr, c["coeffs"])
    # truncated and bit-flipped scans decode or fail cleanly
    from ..errors import UhdrError
    for cut in (0, 1, len(scan) // 2):
        bad = bytearray(scan[:cut] if cut else scan)
        if bad:
            bad[rs.randint(len(bad))] ^= 1 << rs.randint(8)
        try:
            native.decode_scan(bytes(bad), dcomps, mw, mh, dc_tables,
                               ac_tables, restart)
        except UhdrError:
            pass
    # a magnitude of 1024 needs AC category 11, absent from baseline AC
    # tables: refused, never emitted as a corrupt stream
    bad = [dict(comps[0], coeffs=np.full_like(comps[0]["coeffs"], -1024))] \
        + comps[1:]
    try:
        native.encode_scan(bad, mw, mh, dc_tables, ac_tables, mw)
        raise AssertionError("uncodable coefficients were accepted")
    except RuntimeError:
        pass
    for a in out:
        native.idct_plane(a, rs.randint(1, 256, 64).astype(np.int32))


def _join_and_stuff(rs):
    import numpy as np
    from ..jpeg import native
    rows, per_row = int(rs.randint(1, 6)), int(rs.randint(1, 9))
    n = rows * per_row
    blen = rs.randint(0, 200, n).astype(np.uint16)
    # each restart row ends byte-aligned (the device pads its last block)
    for r in range(rows):
        tot = int(blen[r * per_row:(r + 1) * per_row].astype(np.int64).sum())
        blen[(r + 1) * per_row - 1] += (-tot) % 8
    words = np.concatenate([
        rs.randint(0, 1 << 32, -(-int(b) // 32) or 0, dtype=np.uint64)
        .astype(np.uint32) for b in blen] + [np.zeros(0, np.uint32)])
    native.join_blocks(words, blen, per_row)
    seg = rs.choice([0x00, 0xFF, 0x12], int(rs.randint(1, 300))) \
        .astype(np.uint8)
    cuts = np.sort(rs.randint(0, seg.size + 1, int(rs.randint(1, 6))))
    row_off = np.concatenate([[0], cuts, [seg.size]]).astype(np.int32)
    n_rows = row_off.size - 1
    cap = 2 * seg.size + 2 * n_rows + 2
    out = np.empty(cap, np.uint8)
    stuff = _raw_fn("uhdr_stuff_scan", ctypes.c_int64,
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int64])
    wrote = stuff(seg.ctypes.data, row_off.ctypes.data, n_rows,
                  out.ctypes.data, cap)
    assert 0 <= wrote <= cap
    assert stuff(seg.ctypes.data, row_off.ctypes.data, n_rows,
                 out.ctypes.data, min(cap, seg.size)) in (-1, wrote)
    starts = row_off[:-1].astype(np.int64)
    ends = row_off[1:].astype(np.int64)
    ranges = _raw_fn("uhdr_stuff_scan_ranges", ctypes.c_int64,
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int64])
    assert ranges(seg.ctypes.data, starts.ctypes.data, ends.ctypes.data,
                  n_rows, out.ctypes.data, cap) == wrote


def _wire_natives(rs):
    import numpy as np
    from .. import wire
    from ..jpeg import native
    rows = int(rs.randint(1, 64))
    cols = int(rs.randint(1, 64)) * 2
    plane = rs.randint(0, 1 << 16, (rows, cols)).astype(np.uint16)
    if rs.rand() < 0.5:     # smooth content: few escapes
        plane = (np.cumsum(rs.randint(-3, 4, (rows, cols)), axis=1)
                 .astype(np.int64) % 1024 << 6).astype(np.uint16)
    native.pack_p010_10bit(plane)
    for two_d in (False, True):
        for bits in (2, 4, 5, 7, 8):
            native.pack_delta7(plane, uv_interleaved=bool(bits & 1),
                               two_d=two_d, bits=bits)
    n = rows * cols
    for bits in (3, 5, 8):
        for cap in (0, 4, 4096):
            words = np.empty((-(-n // 32), bits), np.uint32)
            ei, ev = np.empty(cap, np.int32), np.empty(cap, np.int32)
            native.pack_delta_g_into(plane >> 6, words, ei, ev, two_d=True,
                                     bits=bits, shift=0, base=512)
            native.pack_delta_g_into(plane, words, ei, ev, two_d=bool(cap),
                                     bits=bits, shift=6, base=512)
    for uv, shift in ((False, 6), (True, 6), (False, 0)):
        g = -(-n // 32)
        widths = np.zeros(-(-g // 8), np.uint32)
        for cap in (g * wire._VW_MAXW, int(rs.randint(0, 8))):
            native.pack_vw_into(plane if shift else plane >> 6, uv, widths,
                                np.empty(cap, np.uint32), shift=shift)
    flat = rs.randint(-1024, 1024, int(rs.randint(1, 200))).astype(np.int16)
    for bits in (2, 4, 8):
        for cap in (0, 64):
            words = np.empty((-(-flat.size // 32), bits), np.uint32)
            native.pack_slices_into(flat, bits, words,
                                    np.empty(cap, np.int32),
                                    np.empty(cap, np.int16))
    for bits in (2, 3, 8):
        words = rs.randint(0, 1 << 32, (-(-n // 32), bits),
                           dtype=np.uint64).astype(np.uint32)
        n_esc = int(rs.randint(0, min(n, 40) + 1))
        idx = np.sort(rs.choice(n, n_esc, replace=False)).astype(np.int32)
        val = rs.randint(-2000, 2000, n_esc).astype(np.int32)
        native.unpack_delta2d(words, idx, val, n_esc, rows, cols, bits, 512)
    packed = rs.randint(0, 1 << 32, (rows, cols), dtype=np.uint64) \
        .astype(np.uint32)
    for shift in (0, 10, 20):
        native.extract_channel10(packed, shift)


_SUBSAMPLING = {"444": (1, 1), "420": (2, 2), "422": (2, 1), "440": (1, 2),
                "411": (4, 1), "410": (4, 2)}


def _colour_natives(rs):
    import numpy as np
    from ..jpeg import native
    h, w = int(rs.randint(1, 40)), int(rs.randint(1, 40))
    y = rs.randint(0, 256, (h, w)).astype(np.uint8)
    cb, cr = (rs.randint(0, 256, (h, w)).astype(np.uint8) for _ in "ab")
    native.ycbcr_to_rgb_planar(y, cb, cr)
    native.ycbcr_to_rgb888(y, cb, cr)
    for key, (hs, vs) in _SUBSAMPLING.items():
        ch, cw = -(-h // vs), -(-w // hs)
        native.ycc_to_rgba32(y, cb[:ch, :cw], cr[:ch, :cw], key, h, w)


def _apply_host(rs):
    import numpy as np
    from ..jpeg import native
    mw, mh, k = int(rs.randint(1, 12)), int(rs.randint(1, 12)), \
        int(rs.randint(1, 5))
    w, h = mw * k, mh * k
    hf, vf = [(1, 1), (2, 1), (2, 2), (1, 2)][rs.randint(4)]
    y = rs.randint(0, 256, (h, w)).astype(np.uint8)
    u, v = (rs.randint(0, 256, (-(-h // vf), -(-w // hf))).astype(np.uint8)
            for _ in "uv")
    chans = (1, 3)[rs.randint(2)]
    planar = chans == 3 and bool(rs.randint(2))
    gm = rs.randint(0, 256, (3, mh, mw) if planar else
                    (mh, mw, 3) if chans == 3 else (mh, mw)).astype(np.uint8)
    meta = np.concatenate([rs.uniform(0.3, 2.5, 3), rs.uniform(0.25, 1, 3),
                           rs.uniform(1, 16, 3), rs.uniform(0, 0.1, 6)])
    gamut = None if rs.rand() < 0.5 else rs.uniform(-0.5, 1.5, (3, 3))
    for out_ct in (0, 1, 2):
        native.apply_gainmap_host(
            y, u, v, hf, vf, w, h, gm, k, meta.astype(np.float32),
            float(rs.uniform(0, 1)), out_ct, gamut,
            gamut_pre=bool(rs.randint(2)), gm_planar=planar)


def drive_natives(trials: int = 8) -> None:
    """Step 3: every native above on `trials` seeded shapes."""
    import numpy as np
    rs = np.random.RandomState(11)
    for trial in range(trials):
        _encode_and_decode(rs, trial)
        _join_and_stuff(rs)
        _wire_natives(rs)
        _colour_natives(rs)
        _apply_host(rs)
    print(f"natives clean under ASan/UBSan on {trials} seeded trials each",
          flush=True)


# ---------------------------------------------------------------------------
# step 4: the sanitized C ABI

def capi_sanitized() -> None:
    """Build the shim and the C programs with UHDR_CAPI_SANITIZE=1 (in a
    process without the preload: the compilers are not sanitized) and run
    them on the CPU."""
    import tempfile
    env = {k: v for k, v in os.environ.items()
           if k not in ("LD_PRELOAD", _CHILD)}
    env["UHDR_CAPI_SANITIZE"] = "1"
    code = ("from libultrahdr_tpu_torch.capi import build as b\n"
            "from libultrahdr_tpu_torch.tools.sanitize_replay import "
            "SMOKE_C\n"
            "s = b.build_shim(linked=True)\n"
            "print(b.build_program('capi_asan_smoke', s, SMOKE_C))\n"
            "print(b.build_program('test_capi', s))\n"
            "print(b.build_program('capi_roundtrip', s))\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"sanitized C ABI build failed:\n{r.stdout}\n"
                         f"{r.stderr}")
    smoke, test, roundtrip = r.stdout.split()[-3:]
    from .. import testing
    from ..capi.build import embed_env
    run_env = embed_env(env)
    run_env.update(SAN_ENV, UHDR_TPU_TORCH_DEVICE="cpu",
                   UHDR_TPU_SANITIZE="1")
    with tempfile.TemporaryDirectory(prefix="uhdr-san-") as tmp:
        img = testing.photo_p010(96, 64)
        raw = pathlib.Path(tmp, "in.p010")
        raw.write_bytes(img.planes[0].tobytes() + img.planes[1].tobytes())
        for exe, args, want in (
                (smoke, [], "capi asan smoke OK"),
                (test, [], "capi round-trip OK"),
                (roundtrip, [str(raw), "96", "64", "2", "1", "95",
                             str(pathlib.Path(tmp, "rt")), "2"],
                 "threads: 2 files equal the sequential one")):
            p = subprocess.run([exe, *args], env=run_env, capture_output=True,
                               text=True, timeout=600)
            if p.returncode != 0 or want not in p.stdout:
                raise SystemExit(
                    f"sanitized {pathlib.Path(exe).name}: exit "
                    f"{p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}")
            print(f"sanitized {pathlib.Path(exe).name}: exit 0, {want}",
                  flush=True)


SMOKE_C = pathlib.Path(__file__).resolve().parent / "capi_asan_smoke.c"


def main() -> int:
    if os.environ.get(_CHILD) != "1":
        return reexec_sanitized()
    from ..jpeg import native
    lib = native.get_lib()
    if "jpeg_entropy_asan" not in lib._name:
        raise SystemExit(f"the host library is not the sanitized build: "
                         f"{lib._name}")
    replayed = replay_corpus()
    assert replayed > 0, "no corpus found"
    drive_natives()
    capi_sanitized()
    print("SANITIZE REPLAY OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
