#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at 3840x2160: the API-0 P010 encode through
``libultrahdr_tpu_torch.UhdrEncoder(device="cuda")``, then the JPEG_R decode
of the files it wrote through ``UhdrDecoder(device="cuda")``, in phases that
each print lines and let any failure propagate (exit code != 0):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build both CUDA kernels (csrc/pack_kernel.cu and csrc/apply_kernel.cu,
   nvcc, sm_90a) and the shared host C++ from the checkout's sources, all
   three compilers started together; print each kernel's ptxas line;
3. hold the pack kernel against its plain PyTorch version on seeded 4:2:0,
   4:4:4 and 4:0:0 coefficient planes with the pack's edge cases: block
   lengths and words must be bit-identical; hold the apply kernel against
   its plain version on seeded inputs at a ragged size over the three
   outputs x use_base_cg x 1-/3-channel gain x gamma {1, 1.571}: the
   packed outputs must be bit-identical;
4. three encodes per configuration (the reference benchmark's: map scale 4,
   single-channel gain map; the library default: scale 1, 3-channel) of
   ``testing.photo_p010(3840, 2160)``, each checked: the MPF container holds
   two JPEGs and the ISO gain-map metadata, the scans decode (shared native
   decoder) to exactly the coefficients the device computed, the bytes equal
   the same encode with the plain entropy stage on the card, and every
   request launched the kernel.  A small image encoded on the card is held
   against the port's CPU encode.  Prints each request's ms and MP/s and the
   kernel's and the plain version's time at the 4K shapes (CUDA events);
5. decodes the benchmark and the default file of phase 4 to HLG, PQ
   (RGBA1010102) and LINEAR (RGBAF16), each checked: the request launched
   the apply kernel exactly once, and its output is bit-identical to the
   plain apply on the card run on the decode's own stage outputs (SDR YUV
   and upsampled gain), as is the kernel alone on them.  The base and
   gain-map IDCT planes on the card equal ``inverse_plane`` on CPU tensors
   bit for bit, and a small image decoded on the card is within
   ``testing.check_decoded_close``'s contract of the port's CPU decode.
   Prints each request's ms and MP/s and the apply kernel's and the plain
   version's time at the 4K shapes (CUDA events);
6. prints one JSON line with the kernel records, then the device line.

It imports nothing of JAX and nothing of the JAX package; there is no CPU
path.
"""

from __future__ import annotations

import concurrent.futures
import itertools
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


def bit_identical(got, want, what: str) -> int:
    """Hold a kernel's packed output against its plain version on the same
    card: 0 when the two are bit-identical, else AssertionError."""
    import numpy as np
    from libultrahdr_tpu_torch import testing
    a, b = testing.host_packed(got), testing.host_packed(want)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: output {a.dtype} {a.shape} vs "
                             f"{b.dtype} {b.shape}")
    if not np.array_equal(a, b):
        raise AssertionError(f"{what}: not bit-identical, {(a != b).mean():.2e}"
                             " of the packed words differ")
    return 0


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
    from libultrahdr_tpu_torch import fused, jpegr, testing
    from libultrahdr_tpu_torch.jpeg import dct, device_entropy, native
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    from libultrahdr_tpu_torch.ops import apply as apply_ops
    from libultrahdr_tpu_torch.ops import apply_kernel as ak
    from libultrahdr_tpu_torch.ops import gainmap, idw, pixel, tonemap
    dev = torch.device("cuda", 0)

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(native.get_lib), pool.submit(pk.PACK_KERNEL.build),
                  pool.submit(ak.APPLY_KERNEL.build)]:
            f.result()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s for both kernels "
        "(nvcc sm_90a) and the host C++, in parallel")
    for kname, kern in (("pack", pk.PACK_KERNEL), ("apply", ak.APPLY_KERNEL)):
        ptxas = [ln.strip() for ln in kern.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"phase 2 {kname} kernel: {kern.build_seconds:.1f} s | "
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

    apply_err = 0
    rs = np.random.RandomState(7)
    ah, aw = 97, 203
    sdr = torch.from_numpy(rs.rand(3, ah, aw).astype(np.float32) - np.array(
        [0.0, 0.5, 0.5], np.float32)[:, None, None]).to(dev)
    gain3 = torch.from_numpy(rs.randint(0, 256, (3, ah, aw)).astype(
        np.float32) / 255.0).to(dev)
    launches0 = ak.APPLY_KERNEL.launches
    for out_ct, use_base_cg, chans, gamma in itertools.product(
            (port.ColorTransfer.HLG, port.ColorTransfer.PQ,
             port.ColorTransfer.LINEAR), (False, True), (1, 3), (1.0, 1.571)):
        rows = np.array([[gamma] * 3, [1.0, 1.0, 1.0],
                         [1000.0 / 203.0, 4.0, 4.9], [1e-7] * 3, [1e-7] * 3],
                        np.float32)
        kw = dict(out_ct=out_ct, sdr_cg=port.ColorGamut.DISPLAY_P3,
                  hdr_cg=port.ColorGamut.BT2100, use_base_cg=use_base_cg)
        g = gain3[:chans].contiguous()
        got = ak.apply_gainmap(sdr, g, rows, 0.31, **kw)
        want = ak.apply_gainmap_plain(sdr, g, rows, 0.31, **kw)
        torch.cuda.synchronize()
        apply_err = max(apply_err, bit_identical(
            got, want, f"apply kernel {out_ct.name} base_cg {use_base_cg} "
            f"{chans}-channel gamma {gamma}"))
        log(f"phase 3 apply kernel == plain: {out_ct.name}, use_base_cg "
            f"{use_base_cg}, {chans}-channel gain, gamma {gamma}, {aw}x{ah}: "
            "bit-identical")
    if ak.APPLY_KERNEL.launches != launches0 + 24:
        raise AssertionError("phase 3 did not launch the apply kernel")

    # ---- phase 4: the main path ------------------------------------------
    w, h = 3840, 2160
    img = testing.photo_p010(w, h)
    configs = {"benchmark": dict(scale=4, multichannel=False),
               "default": dict(scale=1, multichannel=True)}
    outputs = {}
    pk.PACK_KERNEL.launches = 0
    ak.APPLY_KERNEL.launches = 0
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
    if ak.APPLY_KERNEL.launches != 0:
        raise AssertionError("the encode path launched the apply kernel")

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

    if launches < 6:
        raise AssertionError(f"main path launched the kernel {launches} "
                             "times for 6 requests")

    # ---- phase 5: the decode path ----------------------------------------
    outs = (port.ColorTransfer.HLG, port.ColorTransfer.PQ,
            port.ColorTransfer.LINEAR)
    fmt_of = {port.ColorTransfer.HLG: port.ImgFmt.RGBA1010102,
              port.ColorTransfer.PQ: port.ImgFmt.RGBA1010102,
              port.ColorTransfer.LINEAR: port.ImgFmt.RGBAF16}
    decoded = {}
    ak.APPLY_KERNEL.launches = 0
    pk.PACK_KERNEL.launches = 0
    for cfg in configs:
        for ct in outs:
            before = ak.APPLY_KERNEL.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(outputs[cfg][0])
            dec.set_out_color_transfer(ct)
            dec.set_out_img_format(fmt_of[ct])
            img_out = dec.decode()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if ak.APPLY_KERNEL.launches != before + 1:
                raise AssertionError(f"decode {cfg} {ct.name} did not launch "
                                     "the apply kernel exactly once")
            decoded[cfg, ct] = img_out.planes[0]
            log(f"phase 5 decode {cfg} {ct.name}: {ms:.1f} ms, "
                f"{w * h / ms / 1e3:.2f} MP/s, {img_out.w}x{img_out.h} "
                f"{port.ImgFmt(img_out.fmt).name} | {card}")
    apply_launches = ak.APPLY_KERNEL.launches
    if apply_launches != 6 or pk.PACK_KERNEL.launches != 0:
        raise AssertionError(f"decode path launched apply {apply_launches}"
                             f" and pack {pk.PACK_KERNEL.launches} times for "
                             "6 requests")

    apply_rows = {}
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        primary, pinfo, gm_jpeg, gm_info, md, sdr_cg, gm_cg = \
            port.JpegR(device="cuda")._parse_jpegr(data, outs[0])
        base = fused.decode_coefficients(primary, pinfo)
        gmap = fused.decode_coefficients(gm_jpeg, gm_info)
        planes = {}
        for part, info, (coeffs, qts, _) in (("base", pinfo, base),
                                             ("gain map", gm_info, gmap)):
            hmax = max(x.h for x in info.components)
            vmax = max(x.v for x in info.components)
            for i, (c, q, comp) in enumerate(zip(coeffs, qts,
                                                 info.components)):
                ph = -(-info.height * comp.v // vmax)
                pw = -(-info.width * comp.h // hmax)
                on_card = dct.inverse_plane(
                    torch.from_numpy(c).to(dev), q, ph, pw).cpu()
                on_cpu = dct.inverse_plane(torch.from_numpy(c), q, ph, pw)
                if not torch.equal(on_card, on_cpu):
                    raise AssertionError(f"{cfg} {part} plane {i}: IDCT on "
                                         "the card != IDCT on the CPU")
                planes[part, i] = (pw, ph)
        log(f"phase 5 IDCT {cfg}: {len(planes)} planes "
            f"({', '.join(f'{n} {i} {pw}x{ph}' for (n, i), (pw, ph) in planes.items())})"
            " bit-identical on the card and the CPU")

        # the decode's stage outputs on the card, the inputs of its apply
        # (as JpegR._decode_fused_device computes them)
        scale_k = w // gm_info.width
        sdr_yuv, gm_u8 = fused._decode_sdr_and_gain(
            fused.upload_coeff_planes(base[0], dev), base[1],
            fused.upload_coeff_planes(gmap[0], dev), gmap[1], h=h, w=w,
            sampling_key="420", gm_channels=gm_info.num_components,
            scale_k=scale_k)
        gain = idw.idw_upsample(apply_ops._gain_to_float(gm_u8), scale_k,
                                h, w).contiguous()
        rows = ak.meta_to_rows(apply_ops.metadata_to_arrays(md))
        weight = np.float32(apply_ops.gainmap_weight(
            jpegr.FLT_MAX, float(md.hdr_capacity_min),
            float(md.hdr_capacity_max)))
        s_cg = port.ColorGamut(sdr_cg)
        if s_cg == port.ColorGamut.UNSPECIFIED:
            s_cg = port.ColorGamut.BT709
        h_cg = port.ColorGamut(gm_cg)
        if h_cg == port.ColorGamut.UNSPECIFIED:
            h_cg = s_cg
        for ct in outs:
            kw_a = dict(out_ct=ct, sdr_cg=s_cg, hdr_cg=h_cg,
                        use_base_cg=bool(md.use_base_cg))
            p_out = ak.apply_gainmap_plain(sdr_yuv, gain, rows, weight,
                                           **kw_a)
            k_out = ak.APPLY_KERNEL(sdr_yuv, gain, rows, weight, **kw_a)
            apply_err = max(
                apply_err,
                bit_identical(decoded[cfg, ct], p_out,
                              f"decode {cfg} {ct.name} vs plain apply"),
                bit_identical(k_out, p_out,
                              f"apply kernel at 4K {cfg} {ct.name}"))
            plain_ms = cuda_ms(lambda: ak.apply_gainmap_plain(
                sdr_yuv, gain, rows, weight, **kw_a), 5)
            ker_ms = cuda_ms(lambda: ak.APPLY_KERNEL(
                sdr_yuv, gain, rows, weight, **kw_a), 20)
            ker_ms2 = cuda_ms(lambda: ak.APPLY_KERNEL(
                sdr_yuv, gain, rows, weight, **kw_a), 20)
            plain_ms2 = cuda_ms(lambda: ak.apply_gainmap_plain(
                sdr_yuv, gain, rows, weight, **kw_a), 5)
            apply_rows[cfg, ct] = dict(ms=(ker_ms + ker_ms2) / 2,
                                       plain_ms=(plain_ms + plain_ms2) / 2)
            nbytes = (3 + gain.shape[0]) * 4 * w * h \
                + k_out.numel() * k_out.element_size()
            log(f"phase 5 checks {cfg} {ct.name}: decode == plain apply on "
                f"its stage outputs, kernel == plain, bit-identical | apply "
                f"kernel at {w}x{h}, {gain.shape[0]}-channel gain: kernel "
                f"{ker_ms:.3f}/{ker_ms2:.3f} ms ({nbytes / ker_ms / 1e6:.0f} "
                f"GB/s of {nbytes / 1e6:.0f} MB), plain {plain_ms:.3f}/"
                f"{plain_ms2:.3f} ms (CUDA events) | {card}")

    # a small image: the card against the port's CPU decode (which the CPU
    # tests hold against the JAX package)
    small = testing.photo_p010(136, 72)
    for cfg, kw in configs.items():
        enc = port.UhdrEncoder(device="cpu")
        enc.set_raw_image(small, port.ImgLabel.HDR)
        enc.set_gainmap_scale_factor(kw["scale"])
        enc.set_using_multi_channel_gainmap(kw["multichannel"])
        data = enc.encode()
        for ct in outs:
            res = {}
            for d in ("cuda", "cpu"):
                dec = port.UhdrDecoder(device=d)
                dec.set_image(data)
                dec.set_out_color_transfer(ct)
                dec.set_out_img_format(fmt_of[ct])
                res[d] = dec.decode().planes[0]
            err, share = testing.check_decoded_close(
                res["cuda"], res["cpu"], ct, f"small {cfg} {ct.name}")
            log(f"phase 5 small image {cfg} {ct.name}: card decode vs CPU "
                f"decode within the contract, max abs difference {err}, "
                f"{share:.2e} of samples differ")

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "libultrahdr_tpu."))
              or m == "libultrahdr_tpu"]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

    # ---- phase 6: records -------------------------------------------------
    row = kernel_rows["default"]
    arow = apply_rows["default", port.ColorTransfer.HLG]
    log(json.dumps({"kernels": [{
        "name": "pack_scan",
        "route": "cuda",
        "source": "libultrahdr_tpu_torch/csrc/pack_kernel.cu",
        "replaces": "libultrahdr_tpu/jpeg/pack_kernel.py:595",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel_rows.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"]}, {
        "name": "apply_gainmap",
        "route": "cuda",
        "source": "libultrahdr_tpu_torch/csrc/apply_kernel.cu",
        "replaces": "libultrahdr_tpu/ops/pallas_apply.py:177",
        "launches": apply_launches,
        "max_abs_err": apply_err,
        "ms": arow["ms"],
        "plain_ms": arow["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
