#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the API-0 P010 encode, through
``libultrahdr_tpu_torch.UhdrEncoder(device="cuda")`` at 3840x2160, in phases
that each print one line and let any failure propagate (exit code != 0):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernel (csrc/pack_kernel.cu, nvcc, sm_90a) and the shared
   host C++ from the checkout's sources;
3. hold the pack kernel against its plain PyTorch version on seeded 4:2:0,
   4:4:4 and 4:0:0 coefficient planes with the pack's edge cases: block
   lengths and words must be bit-identical;
4. three encodes per configuration (the reference benchmark's: map scale 4,
   single-channel gain map; the library default: scale 1, 3-channel) of
   ``testing.photo_p010(3840, 2160)``, each checked: the MPF container holds
   two JPEGs and the ISO gain-map metadata, the scans decode (shared native
   decoder) to exactly the coefficients the device computed, the bytes equal
   the same encode with the plain entropy stage on the card, and every
   request launched the kernel.  A small image encoded on the card is held
   against the port's CPU encode.  Prints each request's ms and MP/s and the
   kernel's and the plain version's time at the 4K shapes (CUDA events);
5. prints one JSON line with the kernel record, then the device line.

It imports nothing of JAX and nothing of the JAX package; there is no CPU
path.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs (CUDA events,
    after one warm-up run)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a_words, a_blen, b_words, b_blen) -> int:
    """Largest |difference| over block lengths and words (u32 patterns
    compared as int64); raises when the lengths or word counts differ."""
    import torch
    if a_words.shape != b_words.shape or a_blen.shape != b_blen.shape:
        raise AssertionError(f"shapes differ: words {tuple(a_words.shape)} "
                             f"vs {tuple(b_words.shape)}, blen "
                             f"{tuple(a_blen.shape)} vs {tuple(b_blen.shape)}")
    u32 = 0xFFFFFFFF
    dw = (a_words.to(torch.int64) & u32) - (b_words.to(torch.int64) & u32)
    db = a_blen.to(torch.int64) - b_blen.to(torch.int64)
    return int(max(dw.abs().max().item() if dw.numel() else 0,
                   db.abs().max().item()))


def main() -> int:
    import numpy as np
    import torch

    # ---- phase 1: the card ----------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 card: torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        "name and power limit (nvidia-smi):")
    log(card)

    sys.path.insert(0, str(HERE))
    import libultrahdr_tpu_torch as port
    pkg_dir = pathlib.Path(port.__file__).resolve().parent
    if pkg_dir.parent != HERE:
        raise SystemExit(f"chip_smoke: imported the port from {pkg_dir}, "
                         f"not from this checkout ({HERE})")
    from libultrahdr_tpu_torch import fused, testing
    from libultrahdr_tpu_torch.jpeg import device_entropy, native
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    from libultrahdr_tpu_torch.ops import gainmap, pixel, tonemap
    dev = torch.device("cuda", 0)

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    native.get_lib()
    host_s = time.perf_counter() - t0
    pk.PACK_KERNEL.build()
    ptxas = [ln.strip() for ln in pk.PACK_KERNEL.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: pack kernel {pk.PACK_KERNEL.build_seconds:.1f} s "
        f"(nvcc sm_90a), host C++ {host_s:.1f} s | "
        + " | ".join(ptxas))

    # ---- phase 3: kernel against plain on edge-case planes ----------------
    launches0 = pk.PACK_KERNEL.launches
    for sampling, mw, mh in (((2, 2), (1, 1), (1, 1)), 24, 16), \
            (((1, 1), (1, 1), (1, 1)), 37, 21), (((1, 1),), 61, 45):
        layout = device_entropy.scan_layout(sampling, mw, mh)
        planes = [torch.from_numpy(p).to(dev)
                  for p in testing.coefficient_planes(layout, seed=mw)]
        ins = device_entropy.stream_inputs(planes, layout)
        kw, kb = pk.pack_scan(*ins)
        pw, pb = pk.pack_scan_plain(*ins)
        torch.cuda.synchronize()
        err = max_abs_err(kw, kb, pw, pb)
        if err:
            raise AssertionError(f"kernel != plain on {sampling} {mw}x{mh}: "
                                 f"max abs err {err}")
        log(f"phase 3 kernel == plain: sampling {sampling} {mw}x{mh} MCUs, "
            f"{kb.numel()} blocks, {kw.numel()} words, bit-identical")
    if pk.PACK_KERNEL.launches != launches0 + 3:
        raise AssertionError("phase 3 did not launch the kernel")

    # ---- phase 4: the main path ------------------------------------------
    w, h = 3840, 2160
    img = testing.photo_p010(w, h)
    configs = {"benchmark": dict(scale=4, multichannel=False),
               "default": dict(scale=1, multichannel=True)}
    outputs = {}
    pk.PACK_KERNEL.launches = 0
    for cfg, kw in configs.items():
        outputs[cfg] = []
        for req in range(3):
            before = pk.PACK_KERNEL.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = port.UhdrEncoder(device="cuda")
            enc.set_raw_image(img, port.ImgLabel.HDR)
            enc.set_quality(95, port.ImgLabel.BASE)
            enc.set_gainmap_scale_factor(kw["scale"])
            enc.set_using_multi_channel_gainmap(kw["multichannel"])
            data = enc.encode()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if pk.PACK_KERNEL.launches != before + 1:
                raise AssertionError(f"{cfg} request {req} did not launch "
                                     "the pack kernel exactly once")
            outputs[cfg].append(data)
            log(f"phase 4 encode {cfg} request {req}: {ms:.1f} ms, "
                f"{w * h / ms / 1e3:.2f} MP/s, {len(data)} bytes | {card}")
    launches = pk.PACK_KERNEL.launches

    kernel_rows = {}
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        if any(d != data for d in outputs[cfg]):
            raise AssertionError(f"{cfg}: the three requests differ")
        primary, gm_jpeg, md = testing.read_jpegr(data)
        boost = 1000.0 / 203.0
        if not np.allclose(md.max_content_boost, boost, rtol=1e-4):
            raise AssertionError(f"{cfg}: ISO max boost "
                                 f"{md.max_content_boost} != {boost}")
        jr = port.JpegR(device="cuda", map_dimension_scale_factor=kw["scale"],
                        use_multi_channel_gainmap=kw["multichannel"])
        y, uv = fused.upload_p010(img, dev)
        scans = fused._api0_p010_block_buffers(
            y, uv, cg=port.ColorGamut.BT2100, ct=port.ColorTransfer.HLG,
            rng=port.ColorRange.FULL, scale=kw["scale"],
            multichannel=kw["multichannel"], gamma=1.0, quality=95,
            map_quality=95, use_base_cg=False)
        for jpeg, (coeffs, layout) in zip((primary, gm_jpeg), scans):
            got = testing.decode_scan_coeffs(jpeg, layout)
            for g, c in zip(got, coeffs):
                if not np.array_equal(g, c.cpu().numpy()):
                    raise AssertionError(f"{cfg}: decoded scan != device "
                                         "coefficients")
        plain = fused.encode_api0_p010_fused(jr, img, 95, None,
                                             pack=pk.pack_scan_plain)
        if plain != data:
            raise AssertionError(f"{cfg}: kernel encode != plain-entropy "
                                 "encode")
        ins = [torch.cat(p) for p in zip(*(
            device_entropy.stream_inputs(c, lay) for c, lay in scans))]
        kw_, kb_ = pk.pack_scan(*ins)
        pw_, pb_ = pk.pack_scan_plain(*ins)
        err = max_abs_err(kw_, kb_, pw_, pb_)
        if err:
            raise AssertionError(f"{cfg}: kernel != plain at 4K, {err}")
        plain_ms = cuda_ms(lambda: pk.pack_scan_plain(*ins), 5)
        ker_ms = cuda_ms(lambda: pk.pack_scan(*ins), 20)
        ker_ms2 = cuda_ms(lambda: pk.pack_scan(*ins), 20)
        plain_ms2 = cuda_ms(lambda: pk.pack_scan_plain(*ins), 5)
        kernel_rows[cfg] = dict(ms=(ker_ms + ker_ms2) / 2,
                                plain_ms=(plain_ms + plain_ms2) / 2,
                                err=err, blocks=kb_.numel())
        log(f"phase 4 checks {cfg}: container ok ({len(primary)} + "
            f"{len(gm_jpeg)} bytes, ISO boost {md.max_content_boost[0]:.4f}),"
            f" coefficients round-trip exactly, bytes == plain-entropy "
            f"encode | pack at {kb_.numel()} blocks: kernel "
            f"{ker_ms:.3f}/{ker_ms2:.3f} ms, plain {plain_ms:.3f}/"
            f"{plain_ms2:.3f} ms (CUDA events) | {card}")

    # a small image: the card against the port's CPU encode (which the
    # CPU tests hold against the JAX package), SDR and gain-map u8 planes
    # within 1 LSB on at most 1e-3 of the samples
    small = testing.photo_p010(130, 66)
    for cfg, kw in configs.items():
        planes = {}
        for d in ("cuda", "cpu"):
            y, uv = fused.upload_p010(small, torch.device(d))
            hdr = pixel.unpack_p010(y, uv, port.ColorRange.FULL,
                                          small.h, small.w)
            y8, u8, v8 = tonemap.tonemap_to_yuv(
                hdr, port.ImgFmt.P010, port.ColorGamut.BT2100,
                port.ColorTransfer.HLG)
            sdr = pixel.unpack_yuv8(y8, u8, v8, 2, 2, small.h, small.w)
            gm = gainmap.generate_gainmap_onepass(
                sdr, hdr, sdr_fmt=port.ImgFmt.YUV420,
                hdr_fmt=port.ImgFmt.P010,
                sdr_cg=port.ColorGamut.DISPLAY_P3,
                hdr_cg=port.ColorGamut.BT2100, ct=port.ColorTransfer.HLG,
                scale=kw["scale"], multichannel=kw["multichannel"],
                gamma=1.0, use_luminance=False, sdr_is_601=False,
                use_base_cg=False, max_boost=1000.0 / 203.0)
            planes[d] = [p.cpu().numpy().astype(np.int32)
                         for p in (y8, u8, v8, gm)]
        for a, b in zip(planes["cuda"], planes["cpu"]):
            diff = np.abs(a - b)
            if diff.max() > 1 or (diff > 0).mean() > 1e-3:
                raise AssertionError(f"{cfg}: card vs CPU u8 planes differ "
                                     f"(max {diff.max()}, share "
                                     f"{(diff > 0).mean():.2e})")
    log("phase 4 small image: card == CPU port within 1 LSB on <= 1e-3 of "
        "the SDR and gain-map samples, both configurations")

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "libultrahdr_tpu."))
              or m == "libultrahdr_tpu"]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    if launches < 6:
        raise AssertionError(f"main path launched the kernel {launches} "
                             "times for 6 requests")

    # ---- phase 5: records -------------------------------------------------
    row = kernel_rows["default"]
    log(json.dumps({"kernels": [{
        "name": "pack_scan",
        "route": "cuda",
        "source": "libultrahdr_tpu_torch/csrc/pack_kernel.cu",
        "replaces": "libultrahdr_tpu/jpeg/pack_kernel.py:595",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
