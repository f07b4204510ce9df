"""The reference benchmark's matrix on the card: the port's counterpart of
the JAX repository's ``benchmarks.py``.

    python -m libultrahdr_tpu_torch.tools.benchmarks [--quick] [--reps 5]
        [--section enc0|enc1|dec|all] [--size WxH] [--with-8k]
        [--diagnostics] [--json PATH] [--scene photo|grainy|mosaic]
        [--device cuda|cpu]

The rows of the reference's google-benchmark matrix
(``benchmark/benchmark_test.cpp`` of the reference repository), with the
JAX harness's row names:

- ``enc0``, encode API-0 (:62-66): P010 single- and multi-channel gain map
  x gamma {1.0, 1.571}, RGBA1010102 and RGBAF16, map scale 4, REALTIME, q95;
- ``enc1``, encode API-1 (:68-72): P010 + its YUV420 tone map, REALTIME and
  BEST_QUALITY;
- ``dec``, decode (:55-60): a single- and a multi-channel file to HLG and
  PQ (RGBA1010102), LINEAR (RGBAF16) and SRGB (RGBA8888).  Each transfer
  has its ``(public api)`` row (``api.UhdrDecoder``); HLG, PQ and LINEAR
  also ``(host)`` (``JpegR.decode_host``), ``(device-resident)``
  (``decode_to_device(..., microbatch=False)``) and ``(device-serving
  x8)`` (eight ``decode_to_device`` callers on threads through the
  microbatcher, ms an image); ``--diagnostics`` adds ``(device)``
  (``JpegR.decode``, the output downloaded);
- ``--with-8k``: one 8192x4320 API-0 P010 encode.

The default size is 4080x3072, the reference's 12 MP configuration.

Timing: a host clock around each call, every call on the card ending in
``torch.cuda.synchronize()`` inside the clock (the serving rows' batches
run on side streams, which a one-element download would not wait for);
one warm call before the timed ones (kernels are built at first use, and a
process's first decode costs more).  A row reports the median of ``--reps``
calls (the serving rows: of ``max(2, reps // 2)`` rounds of eight, per
image) with ``n``, ``min_ms`` and ``max_ms`` beside it, and MP/s.

Checks, once per row outside the timed calls, on the last output: every
encode's file splits into two JPEGs with ISO gain-map metadata
(``testing.read_jpegr``); each device engine's output is held to the
``(public api)`` row's of its transfer within
``testing.check_decoded_close`` (an SRGB output to equality); the host
engine's, whose IDCT is not libjpeg's islow, to the JAX package's
host-vs-device gate, >= 55 dB a channel.  ``failed`` of ``attempted``
counts them; the exit code is 1 when any row failed.

Each row records the kernel launches of its calls, the warm one included
(the wrappers' counters, set to 0 before the row and read before its
checks), beside ``calls``, the number of times its operation ran.

``--device cpu`` runs the same rows on CPU tensors (each kernel wrapper then
runs its plain version and counts nothing): the CPU test's route.  Without
a GPU the default ``cuda`` raises ``UhdrError``; nothing falls back.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import datetime
import json
import pathlib
import statistics
import sys
import time

import numpy as np

from ..testing import photo_p010
from ..types import (ColorGamut, ColorRange, ColorTransfer, EncPreset,
                     ImgFmt, RawImage)

# the gate tests/test_host_decode.py holds the JAX package's host engine to
# against its device decode, a channel at a time
HOST_GATE_DB = 55.0


def natural_p010(w: int, h: int) -> RawImage:
    """The ``mosaic`` scene: the JAX harness tiles the reference
    repository's P010 test fixture, which this repository does not hold,
    and falls back to ``bench.make_scene`` without it; this is that
    fallback."""
    from .bench import make_scene
    yp, uvp = make_scene(w, h)
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h, [yp, uvp])


def _value_noise(rs, w: int, h: int, oct_px: int) -> np.ndarray:
    """One bilinear value-noise octave at `oct_px` cell size."""
    gh, gw = h // oct_px + 2, w // oct_px + 2
    g = rs.randn(gh, gw).astype(np.float32)
    yy = np.linspace(0, gh - 1.001, h, dtype=np.float32)
    xx = np.linspace(0, gw - 1.001, w, dtype=np.float32)
    y0 = yy.astype(np.int32)
    x0 = xx.astype(np.int32)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    return (g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0 + 1] * fy * fx)


def grainy_p010(w: int, h: int, seed: int = 23) -> RawImage:
    """High-entropy photographic-like P010 scene: multi-octave value noise
    plus sensor grain, the luma's 2D prediction residual about 4 codes of
    standard deviation."""
    rs = np.random.RandomState(seed)
    lum = np.zeros((h, w), np.float32)
    for oct_px, amp in ((256, 0.35), (64, 0.18), (16, 0.06), (8, 0.02)):
        lum += amp * _value_noise(rs, w, h, oct_px)
    lum = 0.5 + 0.3 * lum
    lum += rs.randn(h, w).astype(np.float32) * 0.002
    y10 = np.clip(lum * 1023, 0, 1023).astype(np.uint16) << 6
    cw, ch = w // 2, h // 2
    cu = np.zeros((ch, cw), np.float32)
    cv = np.zeros((ch, cw), np.float32)
    for oct_px, amp in ((128, 0.2), (32, 0.06)):
        cu += amp * _value_noise(rs, cw, ch, oct_px)
        cv += amp * _value_noise(rs, cw, ch, oct_px)
    u10 = np.clip((0.5 + cu) * 1023, 0, 1023).astype(np.uint16) << 6
    v10 = np.clip((0.5 + cv) * 1023, 0, 1023).astype(np.uint16) << 6
    uv = np.empty((ch, w), np.uint16)
    uv[:, 0::2] = u10
    uv[:, 1::2] = v10
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, w, h,
                    [np.ascontiguousarray(y10), np.ascontiguousarray(uv)])


SCENES = {"grainy": grainy_p010, "photo": photo_p010, "mosaic": natural_p010}
SCENE_NOTES = {
    "photo": "testing.photo_p010: tiles of the committed photograph "
             "tests/data/photo_yu12_320x240.npz, per-tile exposure and an "
             "HDR highlight field",
    "grainy": "grainy_p010: multi-octave value noise plus sensor grain, "
              "seed 23",
    "mosaic": "bench.make_scene, the JAX harness's fallback: the reference "
              "repository's P010 fixture (tests/data/raw_p010_image.p010) "
              "that it would tile is not in this repository",
}


def _p010_to_rgba1010102(img: RawImage) -> RawImage:
    """Repack P010 YCbCr as RGBA1010102 carrying the same pixel entropy
    (R = Y, G = Cb, B = Cr; matched content across input formats, not a
    colour conversion)."""
    y = (img.planes[0] >> 6).astype(np.uint32)
    uv = (img.planes[1] >> 6).astype(np.uint32)
    u = np.repeat(np.repeat(uv[:, 0::2], 2, axis=0), 2, axis=1)[:img.h, :img.w]
    v = np.repeat(np.repeat(uv[:, 1::2], 2, axis=0), 2, axis=1)[:img.h, :img.w]
    packed = y | (u << 10) | (v << 20) | np.uint32(0x3 << 30)
    return RawImage(ImgFmt.RGBA1010102, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, img.w, img.h,
                    [np.ascontiguousarray(packed)])


def _p010_to_rgbaf16(img: RawImage) -> RawImage:
    """The same samples / 1023 as LINEAR RGBAF16 half-float bit patterns
    (u16 planes, the library's convention)."""
    y = ((img.planes[0] >> 6).astype(np.float32) / 1023.0)
    uv = img.planes[1]
    comp = np.empty((img.h, img.w, 4), np.float16)
    comp[..., 0] = y.astype(np.float16)
    u = np.repeat(np.repeat(uv[:, 0::2], 2, 0), 2, 1)[:img.h, :img.w]
    v = np.repeat(np.repeat(uv[:, 1::2], 2, 0), 2, 1)[:img.h, :img.w]
    comp[..., 1] = ((u >> 6).astype(np.float32) / 1023.0).astype(np.float16)
    comp[..., 2] = ((v >> 6).astype(np.float32) / 1023.0).astype(np.float16)
    comp[..., 3] = np.float16(1.0)
    return RawImage(ImgFmt.RGBAF16, ColorGamut.BT2100, ColorTransfer.LINEAR,
                    ColorRange.FULL, img.w, img.h,
                    [np.ascontiguousarray(comp).view(np.uint16)])


ROW_NOTES = {
    "(public api)": "UhdrDecoder on the card, its default engine: what a "
                    "library user gets",
    "(device-serving x8)": "decode_to_device under 8 concurrent clients, "
                           "microbatched, ms an image",
    "(host)": "JpegR.decode_host: the native host engine, no device",
    "(device-resident)": "decode_to_device(microbatch=False): the output "
                         "stays on the card",
    "(device)": "JpegR.decode: the card's decode with the output "
                "downloaded",
}


def kernel_counters() -> dict:
    """The launch counters of the port's kernel wrappers, by name."""
    from ..jpeg import dct
    from ..jpeg import pack_kernel as pk
    from ..ops import apply_kernel as ak
    from ..ops import stitch_kernel as sk
    from ..ops import wire_kernel as wk
    return {"pack_scan": pk.PACK_KERNEL, "pack_blocks": pk.PACK_BLOCKS_KERNEL,
            "pack_tiles": pk.PACK_TILES_KERNEL,
            "apply_gainmap": ak.APPLY_KERNEL,
            "forward_dct": dct.FORWARD_DCT_KERNEL,
            "wire_unslice": wk.UNSLICE_KERNEL,
            "down_pack": wk.DOWN_PACK_KERNEL,
            "stitch": sk.STITCH_KERNEL}


def zero_launches() -> None:
    for kern in kernel_counters().values():
        kern.launches = 0
    kernel_counters()["apply_gainmap"].linear_launches = 0


def read_launches() -> dict:
    """Launches since ``zero_launches``; "apply_linear" counts the apply's
    LINEAR launches among its "apply_gainmap" ones."""
    counters = kernel_counters()
    got = {k: kern.launches for k, kern in counters.items()}
    got["apply_linear"] = counters["apply_gainmap"].linear_launches
    return got


def channel_psnr(got, want) -> list[float]:
    """PSNR in dB of each of R, G, B: 10-bit codes (peak 1023) or half
    floats (peak 10000/203)."""
    from ..testing import codes_1010102, host_packed
    a, b = host_packed(got), host_packed(want)
    if a.dtype == np.uint32:
        ca, cb = (codes_1010102(x)[:3].astype(np.float64) for x in (a, b))
        peak = 1023.0
    else:
        ca, cb = (x[..., :3].view(np.float16).astype(np.float64)
                  .transpose(2, 0, 1) for x in (a, b))
        peak = 10000.0 / 203.0
    mse = ((ca - cb) ** 2).mean(axis=(1, 2))
    return [float("inf") if m == 0 else float(10 * np.log10(peak ** 2 / m))
            for m in mse]


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from .profile_encode_pipeline import _card
    card = _card()
    if card is None:
        raise RuntimeError("nvidia-smi did not name the card")
    return card


class Matrix:
    """The rows of one run: each op timed, its launches counted and its
    last output checked."""

    def __init__(self, dev, scene: str, w: int, h: int, reps: int):
        import torch
        self.scene, self.w, self.h, self.reps = scene, w, h, reps
        self.sync = (torch.cuda.synchronize if dev.type == "cuda"
                     else (lambda: None))
        self.rows = []

    def run(self, name: str, f, checks=(), rw: int | None = None,
            rh: int | None = None, reps: int | None = None,
            per_call: int = 1):
        """Time `f` (a warm call, then `reps` calls), then run each of
        `checks` on its last output.  `per_call` images a call: the row
        reports ms an image.  Returns the last output."""
        reps = self.reps if reps is None else reps
        zero_launches()
        out = f()
        self.sync()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = f()
            self.sync()
            ts.append((time.perf_counter() - t0) / per_call)
        launches = read_launches()
        errors = []
        for check in checks:
            try:
                check(out)
            except (AssertionError, ValueError) as e:
                errors.append(f"{type(e).__name__}: {e}")
        rw, rh = rw or self.w, rh or self.h
        dt = statistics.median(ts)
        row = {"config": name, "scene": self.scene,
               "resolution": f"{rw}x{rh}", "ms": dt * 1e3,
               "min_ms": min(ts) * 1e3, "max_ms": max(ts) * 1e3,
               "n": len(ts), "mp_per_s": rw * rh / 1e6 / dt,
               "calls": (reps + 1) * per_call, "launches": launches,
               "attempted": len(checks), "failed": len(errors),
               "errors": errors}
        self.rows.append(row)
        print(f"  {name}: {row['ms']:.1f} ms  {row['mp_per_s']:.2f} MP/s"
              f"{'  FAILED ' + '; '.join(errors) if errors else ''}",
              flush=True)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="1280x720, 1 rep (smoke test)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--section", choices=["enc0", "enc1", "dec", "all"],
                    default="all")
    ap.add_argument("--size", default=None, metavar="WxH",
                    help="resolution (default 4080x3072, the reference's "
                         "12 MP benchmark configuration)")
    ap.add_argument("--with-8k", action="store_true",
                    help="append an 8192x4320 single-image encode row")
    ap.add_argument("--diagnostics", action="store_true",
                    help="include the '(device)' decode rows (JpegR.decode "
                         "with the output downloaded)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the result matrix as a JSON artifact")
    ap.add_argument("--scene", choices=["mosaic", "grainy", "photo"],
                    default="photo")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from .. import api, testing
    from ..jpegr import JpegR, resolve_device
    dev = resolve_device(args.device)
    device = str(dev)

    if args.quick:
        w, h, reps = 1280, 720, 1
    else:
        w, h, reps = 4080, 3072, args.reps
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
    mp = w * h / 1e6
    hdr = SCENES[args.scene](w, h)
    m = Matrix(dev, args.scene, w, h, reps)
    enc_checks = (testing.read_jpegr,)

    # ---- encode API-0 matrix ------------------------------------------
    if args.section in ("enc0", "all"):
        for multi in (False, True):
            for gamma in (1.0, 1.571):
                jr = JpegR(map_dimension_scale_factor=4,
                           use_multi_channel_gainmap=multi, gamma=gamma,
                           preset=EncPreset.REALTIME, device=device)
                tag = "multi" if multi else "single"
                m.run(f"enc api0 p010 {tag} g={gamma}",
                      lambda jr=jr: jr.encode_api0(hdr, quality=95),
                      enc_checks)
        jr = JpegR(map_dimension_scale_factor=4,
                   use_multi_channel_gainmap=False,
                   preset=EncPreset.REALTIME, device=device)
        rgba10 = _p010_to_rgba1010102(hdr)
        m.run("enc api0 rgba1010102 single g=1.0",
              lambda: jr.encode_api0(rgba10, quality=95), enc_checks)
        rgbaf16 = _p010_to_rgbaf16(hdr)
        m.run("enc api0 rgbaf16 single g=1.0",
              lambda: jr.encode_api0(rgbaf16, quality=95), enc_checks)

    # ---- encode API-1 matrix ------------------------------------------
    if args.section in ("enc1", "all"):
        sdr420 = JpegR(device=device).tone_map(hdr)
        for preset in (EncPreset.REALTIME, EncPreset.BEST_QUALITY):
            jr = JpegR(map_dimension_scale_factor=4, preset=preset,
                       device=device)
            m.run(f"enc api1 p010+yuv420 {preset.name.lower()}",
                  lambda jr=jr: jr.encode_api1(hdr, sdr420, quality=95),
                  enc_checks)

    # ---- decode matrix -------------------------------------------------
    if args.section in ("dec", "all"):
        for multi in (False, True):
            jr = JpegR(map_dimension_scale_factor=4,
                       use_multi_channel_gainmap=multi, device=device)
            data = jr.encode_api0(hdr, quality=95)
            tag = "multi" if multi else "single"
            for ct, fmt in [(ColorTransfer.HLG, ImgFmt.RGBA1010102),
                            (ColorTransfer.PQ, ImgFmt.RGBA1010102),
                            (ColorTransfer.LINEAR, ImgFmt.RGBAF16),
                            (ColorTransfer.SRGB, ImgFmt.RGBA8888)]:
                d = JpegR(device=device)
                label = f"dec {tag} -> {ct.name.lower()}"

                def routed(data=data, ct=ct, fmt=fmt):
                    dec = api.UhdrDecoder(device=device)
                    dec.set_image(data)
                    dec.set_out_color_transfer(ct)
                    dec.set_out_img_format(fmt)
                    return dec.decode().planes[0]

                def is_output(p, fmt=fmt):
                    want = ((h, w, 4), np.uint16) if fmt == ImgFmt.RGBAF16 \
                        else ((h, w), np.uint32)
                    got = (np.shape(p), np.asarray(p).dtype)
                    if got != want:
                        raise AssertionError(f"output {got}, not {want}")

                public = m.run(f"{label} (public api)", routed, (is_output,))

                def close(got, public=public, ct=ct, what=""):
                    # an equal output is within the contract: the full
                    # check (seconds at 12 MP) runs only on a difference
                    if np.array_equal(testing.host_packed(got),
                                      testing.host_packed(public)):
                        return
                    if ct == ColorTransfer.SRGB:
                        raise AssertionError(f"{what}: != (public api)")
                    testing.check_decoded_close(got, public, ct, what)

                if args.diagnostics:
                    m.run(f"{label} (device)",
                          lambda d=d, data=data, ct=ct, fmt=fmt: d.decode(
                              data, output_ct=ct,
                              output_fmt=fmt)[0].planes[0],
                          (lambda o, c=close: c(o, what="(device)"),))
                if ct == ColorTransfer.SRGB:
                    continue

                def host_gate(got, public=public):
                    db = channel_psnr(got, public)
                    if min(db) < HOST_GATE_DB:
                        raise AssertionError(f"(host): {db} dB a channel "
                                             "against (public api)")

                m.run(f"{label} (host)",
                      lambda d=d, data=data, ct=ct: d.decode_host(
                          data, output_ct=ct)[0].planes[0], (host_gate,))
                m.run(f"{label} (device-resident)",
                      lambda d=d, data=data, ct=ct: d.decode_to_device(
                          data, output_ct=ct, microbatch=False)[0],
                      (lambda o, c=close: c(o, what="(device-resident)"),))

                def serving(d=d, data=data, ct=ct, n=8):
                    with cf.ThreadPoolExecutor(n) as ex:
                        return [arr for arr, _ in ex.map(
                            lambda x: d.decode_to_device(x, output_ct=ct),
                            [data] * n)]

                m.run(f"{label} (device-serving x8)", serving,
                      [lambda outs, i=i, c=close: c(
                          outs[i], what=f"(device-serving x8) client {i}")
                       for i in range(8)],
                      reps=max(2, reps // 2), per_call=8)

    if args.with_8k:
        w8, h8 = 8192, 4320
        hdr8 = SCENES[args.scene](w8, h8)
        jr8 = JpegR(map_dimension_scale_factor=4,
                    use_multi_channel_gainmap=False,
                    preset=EncPreset.REALTIME, device=device)
        m.run(f"enc api0 p010 single 8k ({w8}x{h8})",
              lambda: jr8.encode_api0(hdr8, quality=95), enc_checks,
              rw=w8, rh=h8)

    width = max(len(r["config"]) for r in m.rows)
    print(f"\n{'config':<{width}}  {'ms':>9}  {'MP/s':>8}  failed")
    for r in m.rows:
        print(f"{r['config']:<{width}}  {r['ms']:9.1f}  "
              f"{r['mp_per_s']:8.2f}  {r['failed']}/{r['attempted']}")

    if args.json:
        artifact = {
            "resolution": f"{w}x{h}",
            "megapixels": mp,
            "scene": args.scene,
            "scene_note": SCENE_NOTES[args.scene],
            "reps": reps,
            "date": datetime.date.today().isoformat(),
            "device": card_name(dev),
            "row_notes": ROW_NOTES,
            "rows": m.rows,
        }
        pathlib.Path(args.json).write_text(json.dumps(artifact, indent=1)
                                           + "\n")
        print(f"wrote {args.json}")
    failed = [r["config"] for r in m.rows if r["failed"]]
    if failed:
        print(f"benchmarks: checks failed on {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
