#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at 3840x2160: the API-0 encode of P010,
RGBA1010102 and RGBAF16 input through
``libultrahdr_tpu_torch.UhdrEncoder(device="cuda")`` and of YUV444_10 input
through ``JpegR(device="cuda").encode_api0``, the API-1 encode (raw HDR +
raw SDR, both presets) and one API-2, API-3 and API-4 encode through
``UhdrEncoder``, the JPEG_R decode of
the P010 files through ``UhdrDecoder(device="cuda")``, then the slot-input
block-pack and tile-pack routes on the encode's scans, in phases that each
print lines and let any failure propagate (exit code != 0).  Every path is
driven with all kernel launch counts set to 0 just before it and read just
after:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the three CUDA kernel libraries (csrc/pack_kernel.cu,
   csrc/block_pack_kernel.cu and csrc/apply_kernel.cu, nvcc, sm_90a) and the
   host C++ (csrc/host/) from the checkout's sources, all four compilers started
   together; print each kernel's ptxas line (registers, static shared
   memory, spills);
3. hold the pack kernel, the block pack and the tile pack against their
   plain PyTorch versions on seeded 4:2:0, 4:4:4 and 4:0:0 coefficient
   planes with the pack's edge cases (block counts that are and are not a
   multiple of the pack kernel's 128-block tile), the pack kernel also on
   320 blocks at its word cap (testing.pack_worst_case_stream), and the
   tile pack also on a dense tile that overflows budget 16
   (check_tile_budgets must raise), and both on testing.synthetic_slots
   where the block pack's 32-block groups and the tile pack's split of a
   tile over a cluster of CTAs matter (1 block, fewer than a sub-tile, no
   multiple of one, four tiles with a ragged last, three tiles whose middle
   one alone overflows from a later sub-tile on): every output bit-identical
   (torch.equal; the tile pack on its block lengths and every tile's live
   prefix, the rest of a tile being undefined), and the pack kernel's
   twice the same; hold the apply kernel's device tables against the plain
   ops on their LUT grids (testing.apply_tables_plain, torch.equal), and
   the apply kernel against its plain version on seeded inputs at a ragged
   size over the three outputs x use_base_cg x 1-/3-channel gain x gamma
   {1, 1.571}, and on testing.apply_edge_inputs (grid ties, values outside
   [0, 1], NaN) at a size with H*W % 4 == 0 and one without, twice: the
   packed outputs must be bit-identical;
4. three encodes per configuration (the reference benchmark's: map scale 4,
   single-channel gain map; the library default: scale 1, 3-channel) of
   ``testing.photo_p010(3840, 2160)``, then two each of
   ``testing.photo_rgba1010102`` (HLG), ``photo_rgbaf16`` (LINEAR) and
   ``photo_yuv444_10`` (HLG) at 3840x2160, each checked: the MPF container
   holds two JPEGs and the ISO gain-map metadata, the scans decode (shared
   native decoder) to exactly the coefficients the device computed, the
   bytes equal the same encode with the plain entropy stage on the card,
   and every request launched the pack kernel once.  Small P010, RGB and
   YUV444_10 images encoded on the card are held against the port's CPU
   encode.  Prints each request's ms and MP/s and the pack kernel's (alone
   and through its wrapper) and its plain version's time at the 4K shapes
   (CUDA events) beside its bound;
4b. API-1 through ``UhdrEncoder``: the P010 HDR of phase 4 with
   ``JpegR(device="cuda").tone_map`` of it as the SDR (YUV420, Display-P3),
   REALTIME and BEST_QUALITY (the two-pass gain map) in both
   configurations, a warm-up and two requests each, and one RGBA1010102 HDR
   + RGBA8888 SDR request per preset (default configuration), each
   launching the pack kernel exactly once and checked as in phase 4 (ISO
   boosts against the card's own bounds); then one API-2, API-3 and API-4
   request built from the default BEST_QUALITY file's parts (its base as
   the compressed SDR, its gain map and metadata), launching no kernel:
   the primary image equals the compressed SDR, API-4's gain map its
   input, API-2/3's gain-map JPEG the general path's on the card, API-3's
   SDR planes decoded on the card those on the CPU.  Small images: API-1's
   base planes (a BT.709 SDR re-encoded as BT.601) and gain maps on the
   card against the CPU port, both presets and configurations.  Prints
   each request's ms and MP/s;
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
6. the block-pack and tile-pack routes (testing.pack_scans_v1 /
   pack_scans_v2) pack each configuration's P010 scans in one launch each:
   their joined scans equal the scans of the encode's JPEG_R, and each
   kernel equals its plain version at those shapes.  Prints each kernel's
   time alone and through its wrapper, and its plain version's (CUDA
   events), beside its bound;
7. prints one JSON line with the kernel records (launches on the paths,
   max abs error against the plain version, ms through the wrapper, the
   launch alone as kernel_ms for the three pack kernels (null for the
   apply, whose wrapper is one launch), plain ms, the bound), then the
   device line.

It imports nothing of JAX and nothing of the JAX package; there is no CPU
path.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import pathlib
import re
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


def tensors_equal(got, want, what: str) -> int:
    """Hold a kernel's output tensors against its plain version's on the
    same card: 0 when every pair is torch.equal, else AssertionError."""
    import torch
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version ({a.dtype} {tuple(a.shape)} vs "
                                 f"{b.dtype} {tuple(b.shape)})")
    return 0


def tiles_equal(got, want, what: str) -> int:
    """Hold the tile pack's (tiles, blen) against its plain version's: blen
    and every tile's live prefix torch.equal (the rest of a tile is
    undefined, as on the TPU)."""
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    (gt, gb), (wt, wb) = got, want
    if gt.shape != wt.shape:
        raise AssertionError(f"{what}: tiles {tuple(gt.shape)} vs "
                             f"{tuple(wt.shape)}")
    live = pk.tile_live_words(wb)
    return tensors_equal((gb, pk.stitch_tiles([(gt, live)])),
                         (wb, pk.stitch_tiles([(wt, live)])), what)


def live_tile_bytes(tiles, blen) -> int:
    """Bytes of the tile pack's words that a run must write: each tile's
    live words, at most its budget."""
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    live = pk.tile_live_words(blen).clamp(max=tiles.shape[1])
    return 4 * int(live.sum())


# Peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit): device
# memory bytes per second, and 32-bit operations per second outside the
# tensor cores (the float32 rate; the kernels here do 32-bit integer and
# float work)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, or its operations over the 32-bit rate, whichever
    is larger."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_report(build_log: str) -> list[str]:
    """Each kernel's line of `nvcc -Xptxas -v`: its name (the last
    component of the entry function's mangled name, template arguments
    left mangled), stack and spills, registers, barriers and static shared
    memory."""
    out = []
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", ln)
        if m:
            rest, name = m.group(1), ""
            while (num := re.match(r"\d+", rest)):
                size = int(num.group())
                name, rest = rest[num.end():num.end() + size], \
                    rest[num.end() + size:]
            args = re.match(r"I(\w+?)EE", rest)
            out.append(name + (f"<{args.group(1)}>" if args else "") + ":")
        elif ("registers" in ln or "spill" in ln) and out:
            out[-1] += " " + ln.strip().removeprefix("ptxas info    : ")
    return out


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
    from libultrahdr_tpu_torch.jpeg import decoder as jpeg_decoder
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    from libultrahdr_tpu_torch.ops import apply as apply_ops
    from libultrahdr_tpu_torch.ops import apply_kernel as ak
    from libultrahdr_tpu_torch.ops import colors, gainmap, idw, pixel, tonemap
    dev = torch.device("cuda", 0)
    CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt

    counted = {"pack_scan": pk.PACK_KERNEL, "pack_blocks": pk.PACK_BLOCKS_KERNEL,
               "pack_tiles": pk.PACK_TILES_KERNEL,
               "apply_gainmap": ak.APPLY_KERNEL}

    def zero_counts():
        for kern in counted.values():
            kern.launches = 0

    def read_counts(path: str, want: dict) -> dict:
        """The launch counts after driving `path`; raises unless they are
        `want` (kernels not named there: 0)."""
        got = {k: kern.launches for k, kern in counted.items()}
        if got != {k: want.get(k, 0) for k in counted}:
            raise AssertionError(f"{path}: kernel launches {got}, expected "
                                 f"{want}")
        log(f"launches on the {path} path: {got}")
        return got

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    libs = (("pack", pk.PACK_LIB), ("block pack", pk.BLOCK_PACK_LIB),
            ("apply", ak.APPLY_LIB))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(native.get_lib)] + [
                pool.submit(lib.build) for _, lib in libs]:
            f.result()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s for the three "
        "kernel libraries (nvcc sm_90a) and the host C++, in parallel")
    for kname, lib in libs:
        log(f"phase 2 {kname} kernel: {lib.build_seconds:.1f} s | "
            + " | ".join(ptxas_report(lib.build_log)))

    # ---- phase 3: kernels against plain on edge-case planes ---------------
    launches0 = {k: kern.launches for k, kern in counted.items()}
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
        tensors_equal(pk.pack_scan(*ins), (kw, kb),
                      f"pack kernel run twice on {sampling} {mw}x{mh}")
        log(f"phase 3 kernel == plain: sampling {sampling} {mw}x{mh} MCUs, "
            f"{kb.numel()} blocks, {kw.numel()} words, bit-identical, and "
            "the same when run again")
        pays, lens = pk.slots_for_kernel(planes, layout)
        tensors_equal(pk.pack_blocks(pays, lens),
                      pk.pack_blocks_plain(pays, lens),
                      f"block pack on {sampling} {mw}x{mh}")
        tiles_equal(pk.pack_tiles(pays, lens, 16),
                    pk.pack_tiles_plain(pays, lens, 16),
                    f"tile pack on {sampling} {mw}x{mh}")
        torch.cuda.synchronize()
        log(f"phase 3 block pack == plain, tile pack (budget 16) == plain on "
            f"the live prefixes: {pays.shape[0]} blocks, torch.equal")
    # a dense 2048-block tile (every AC coefficient of magnitude 512-1023,
    # about 50 words a block) overflows budget 16: the tile pack drops the
    # same tail as its plain version, and the host check refuses it
    rs = np.random.RandomState(3)
    dense = np.zeros((32, 64, 64), np.int16)
    dense[..., 0] = rs.randint(-300, 300, (32, 64))
    dense[..., 1:] = np.where(rs.rand(32, 64, 63) < 0.5, -1, 1) \
        * rs.randint(512, 1024, (32, 64, 63))
    layout = device_entropy.scan_layout(((1, 1),), 64, 32)
    pays, lens = pk.slots_for_kernel([torch.from_numpy(dense).to(dev)],
                                     layout)
    tiles, tblen = pk.pack_tiles(pays, lens, 16)
    tiles_equal((tiles, tblen), pk.pack_tiles_plain(pays, lens, 16),
                "tile pack on an overflowing tile")
    try:
        pk.check_tile_budgets(tblen.cpu().numpy(), 16)
    except device_entropy.PackOverflowError as e:
        log(f"phase 3 tile pack == plain on an overflowing tile (live "
            f"prefixes up to the budget), torch.equal; check_tile_budgets "
            f"raised: {e}")
    else:
        raise AssertionError("the dense tile did not overflow budget 16")
    # blocks at the pack kernel's word cap, 40 times over: 320 blocks (two
    # tiles and a half), most of them longer than their shared-memory slot
    worst = [t.repeat(40, *([1] * (t.dim() - 1))).contiguous().to(dev)
             for t in testing.pack_worst_case_stream()]
    got = pk.pack_scan(*worst)
    tensors_equal(got, pk.pack_scan_plain(*worst),
                  "pack kernel on the worst-case blocks")
    tensors_equal(pk.pack_scan(*worst), got,
                  "pack kernel run twice on the worst-case blocks")
    log(f"phase 3 pack kernel == plain on {got[1].numel()} worst-case "
        f"blocks (blen up to {int(got[1].max())} of "
        f"{32 * pk.CAP_WORDS} bits), torch.equal, and the same run again")
    # the block pack's groups and the tile pack's split of a tile over a
    # cluster of CTAs: 1 block, fewer blocks than a sub-tile, a count that
    # is no multiple of one, four tiles with a ragged last, and three tiles
    # whose middle one alone overflows budget 16, from a later sub-tile on
    # (testing.synthetic_slots)
    tile = pk._TILE
    for what, n, dense in (
            ("a single block", 1, ()), ("less than a sub-tile", 100, ()),
            ("no multiple of a sub-tile", tile + 5 * 128 + 57, ()),
            ("4 tiles, the last ragged", 3 * tile + 333, ()),
            ("3 tiles, the middle one overflowing", 3 * tile,
             ((tile + 640, 2 * tile),))):
        pays, lens = (t.to(dev) for t in testing.synthetic_slots(
            n, seed=n, dense=dense))
        tensors_equal(pk.pack_blocks(pays, lens),
                      pk.pack_blocks_plain(pays, lens),
                      f"block pack on {what}")
        tiles, tblen = pk.pack_tiles(pays, lens, 16)
        tiles_equal((tiles, tblen), pk.pack_tiles_plain(pays, lens, 16),
                    f"tile pack on {what}")
        live = pk.tile_live_words(tblen).cpu()
        over = (live > tiles.shape[1]).nonzero().flatten().tolist()
        if over != ([1] if dense else []):
            raise AssertionError(f"tile pack on {what}: tiles {over} over "
                                 "budget 16")
        log(f"phase 3 block pack == plain, tile pack (budget 16) == plain on "
            f"the live prefixes: {what} ({n} blocks, {tiles.shape[0]} "
            f"tiles, {live.tolist()[:4]} live words, tiles over budget "
            f"{over}), torch.equal")
    want3 = {"pack_scan": 8, "pack_blocks": 8, "pack_tiles": 9}
    for k, n in want3.items():
        if counted[k].launches != launches0[k] + n:
            raise AssertionError(f"phase 3 did not launch the {k} kernel")

    apply_err = 0
    rs = np.random.RandomState(7)
    ah, aw = 97, 203
    sdr = torch.from_numpy(rs.rand(3, ah, aw).astype(np.float32) - np.array(
        [0.0, 0.5, 0.5], np.float32)[:, None, None]).to(dev)
    gain3 = torch.from_numpy(rs.randint(0, 256, (3, ah, aw)).astype(
        np.float32) / 255.0).to(dev)
    launches0 = ak.APPLY_KERNEL.launches
    for out_ct, use_base_cg, chans, gamma in itertools.product(
            (CT.HLG, CT.PQ, CT.LINEAR), (False, True), (1, 3), (1.0, 1.571)):
        rows = np.array([[gamma] * 3, [1.0, 1.0, 1.0],
                         [1000.0 / 203.0, 4.0, 4.9], [1e-7] * 3, [1e-7] * 3],
                        np.float32)
        kw = dict(out_ct=out_ct, sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100,
                  use_base_cg=use_base_cg)
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
    # the device tables against the plain ops on their LUT grids
    dev_t, plain_t = ak.APPLY_KERNEL.tables(dev), testing.apply_tables_plain(dev)
    tensors_equal((dev_t["srgb"], dev_t["hlg"].to(torch.int32),
                   dev_t["pq"].to(torch.int32)),
                  (plain_t["srgb"], plain_t["hlg"], plain_t["pq"]),
                  "apply kernel tables")
    log("phase 3 apply kernel tables == plain ops on their grids: sRGB "
        "inverse (1024 f32), HLG and PQ 10-bit codes (65536 each), "
        "torch.equal")
    # grid ties, values outside [0, 1] and NaN, on the vector path (H*W %
    # 4 == 0) and the scalar one, each run twice
    for (eh, ew), out_ct, chans, gamma in itertools.product(
            ((48, 64), (37, 53)), (CT.HLG, CT.PQ, CT.LINEAR), (1, 3),
            (1.0, 1.571)):
        sdr_e, gain_e, rows_e = testing.apply_edge_inputs(eh, ew, chans,
                                                          gamma)
        sdr_e, gain_e = (torch.from_numpy(a).to(dev) for a in (sdr_e, gain_e))
        kw = dict(out_ct=out_ct, sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100,
                  use_base_cg=gamma != 1.0)
        got = ak.apply_gainmap(sdr_e, gain_e, rows_e, 0.8, **kw)
        what = f"apply kernel {out_ct.name} {chans}-channel gamma {gamma} " \
            f"on edge inputs {ew}x{eh}"
        bit_identical(got, ak.apply_gainmap_plain(sdr_e, gain_e, rows_e, 0.8,
                                                  **kw), what)
        bit_identical(ak.apply_gainmap(sdr_e, gain_e, rows_e, 0.8, **kw), got,
                      what + ", run twice")
    log("phase 3 apply kernel == plain on grid ties, values outside [0, 1] "
        "and NaN at 64x48 and 53x37 (3 outputs x 1-/3-channel x gamma {1, "
        "1.571}): bit-identical, and the same run again")

    # ---- phase 4: the encode paths ---------------------------------------
    w, h = 3840, 2160
    configs = {"benchmark": dict(scale=4, multichannel=False),
               "default": dict(scale=1, multichannel=True)}

    def encode(img, kw, what: str) -> bytes:
        """One request on the card through UhdrEncoder, or for YUV444_10
        (which the encoder API, like the reference's, does not take as an
        HDR intent) through JpegR.encode_api0; it must launch the pack
        kernel exactly once."""
        before = pk.PACK_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if Fmt(img.fmt) == Fmt.YUV444_10:
            data = port.JpegR(
                device="cuda", map_dimension_scale_factor=kw["scale"],
                use_multi_channel_gainmap=kw["multichannel"]).encode_api0(
                    img, 95)
        else:
            enc = port.UhdrEncoder(device="cuda")
            enc.set_raw_image(img, port.ImgLabel.HDR)
            enc.set_quality(95, port.ImgLabel.BASE)
            enc.set_gainmap_scale_factor(kw["scale"])
            enc.set_using_multi_channel_gainmap(kw["multichannel"])
            data = enc.encode()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if pk.PACK_KERNEL.launches != before + 1:
            raise AssertionError(f"{what} did not launch the pack kernel "
                                 "exactly once")
        log(f"phase 4 encode {what}: {ms:.1f} ms, {w * h / ms / 1e3:.2f} "
            f"MP/s, {len(data)} bytes | {card}")
        return data

    def check_encode(data, img, kw, block_buffers, planes, encode_fn, what,
                     **bb_kw):
        """The phase-4 checks of a request's file: container and ISO boost,
        scans that decode to the device's coefficients, bytes equal to the
        plain-entropy encode.  Returns (primary, gain-map JPEG, scans)."""
        primary, gm_jpeg, md = testing.read_jpegr(data)
        cg, ct = CG(img.cg), CT(img.ct)
        boost = colors.reference_display_peak_nits(ct) / 203.0
        if not np.allclose(md.max_content_boost, boost, rtol=1e-4):
            raise AssertionError(f"{what}: ISO max boost "
                                 f"{md.max_content_boost} != {boost}")
        jr = port.JpegR(device="cuda", map_dimension_scale_factor=kw["scale"],
                        use_multi_channel_gainmap=kw["multichannel"])
        scans = block_buffers(
            *fused.upload_planes(planes, dev), cg=cg, ct=ct,
            scale=kw["scale"], multichannel=kw["multichannel"], gamma=1.0,
            quality=95, map_quality=95,
            use_base_cg=fused._use_base_cg(CG.DISPLAY_P3, cg, jr.write_xmp),
            **bb_kw)
        for jpeg, (coeffs, layout) in zip((primary, gm_jpeg), scans):
            got = testing.decode_scan_coeffs(jpeg, layout)
            for g, c in zip(got, coeffs):
                if not np.array_equal(g, c.cpu().numpy()):
                    raise AssertionError(f"{what}: decoded scan != device "
                                         "coefficients")
        if encode_fn(jr, img, 95, None, pack=pk.pack_scan_plain) != data:
            raise AssertionError(f"{what}: kernel encode != plain-entropy "
                                 "encode")
        log(f"phase 4 checks {what}: container ok ({len(primary)} + "
            f"{len(gm_jpeg)} bytes, ISO boost {md.max_content_boost[0]:.4f}),"
            f" coefficients round-trip exactly, bytes == plain-entropy "
            f"encode | {card}")
        return primary, gm_jpeg, scans

    # P010 (the reference app's benchmark input)
    img = testing.photo_p010(w, h)
    p010_planes = [np.asarray(p, np.uint16) for p in img.planes[:2]]
    outputs = {}
    zero_counts()
    for cfg, kw in configs.items():
        outputs[cfg] = [encode(img, kw, f"P010 {cfg} request {req}")
                        for req in range(3)]
    p010_launches = read_counts("P010 encode", {"pack_scan": 6})

    kernel_rows, p010_scans, p010_jpegs = {}, {}, {}
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        if any(d != data for d in outputs[cfg]):
            raise AssertionError(f"{cfg}: the three requests differ")
        primary, gm_jpeg, scans = check_encode(
            data, img, kw, fused._api0_p010_block_buffers, p010_planes,
            fused.encode_api0_p010_fused, f"P010 {cfg}",
            rng=port.ColorRange.FULL)
        p010_scans[cfg], p010_jpegs[cfg] = scans, (primary, gm_jpeg)
        ins = [torch.cat(p) for p in zip(*(
            device_entropy.stream_inputs(c, lay) for c, lay in scans))]
        kw_, kb_ = pk.pack_scan(*ins)
        pw_, pb_ = pk.pack_scan_plain(*ins)
        err = max_abs_err(kw_, kb_, pw_, pb_)
        if err:
            raise AssertionError(f"{cfg}: kernel != plain at 4K, {err}")
        tensors_equal(pk.pack_scan(*ins), (kw_, kb_),
                      f"{cfg}: pack kernel run twice at 4K")
        plain_ms = cuda_ms(lambda: pk.pack_scan_plain(*ins), 5)
        ker_ms = testing.pack_kernel_ms(ins)
        wrap_ms = cuda_ms(lambda: pk.pack_scan(*ins), 20)
        wrap_ms2 = cuda_ms(lambda: pk.pack_scan(*ins), 20)
        ker_ms2 = testing.pack_kernel_ms(ins)
        plain_ms2 = cuda_ms(lambda: pk.pack_scan_plain(*ins), 5)
        # ~4 integer operations per AC position scanned, ~12 more for each
        # nonzero coefficient and each DC (category, table, value bits, put)
        nnz = int((ins[0][:, 1:] != 0).sum()) + kb_.numel()
        b_ms, b_by = bound(nbytes(*ins, kw_, kb_),
                           4 * 63 * kb_.numel() + 12 * nnz)
        # ms: the wrapper, as each encode pays it (launch, read of the
        # total); kernel_ms: the launch alone
        kernel_rows[cfg] = dict(ms=(wrap_ms + wrap_ms2) / 2,
                                kernel_ms=(ker_ms + ker_ms2) / 2,
                                plain_ms=(plain_ms + plain_ms2) / 2,
                                err=err, bound_ms=b_ms, bound_by=b_by)
        log(f"phase 4 pack kernel {cfg} at {kb_.numel()} blocks, the same "
            f"run twice: kernel alone {ker_ms:.4f}/{ker_ms2:.4f} ms, "
            f"wrapper {wrap_ms:.4f}/{wrap_ms2:.4f} ms, plain {plain_ms:.3f}/"
            f"{plain_ms2:.3f} ms (CUDA events), bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes(*ins, kw_, kb_) / 1e6:.1f} MB) | {card}")

    # RGBA1010102 / RGBAF16 and YUV444_10 (raw upload, 4:4:4 base):
    # name -> (image, its block buffers, their planes and keywords, encode)
    yuv_img = testing.photo_yuv444_10(w, h)
    rgb_imgs = {
        name: (rimg, fused._api0_rgb_block_buffers, rimg.planes[:1],
               dict(fmt=Fmt(rimg.fmt)), fused.encode_api0_rgb_fused)
        for name, rimg in (
            ("RGBA1010102 HLG", testing.photo_rgba1010102(w, h)),
            ("RGBAF16 LINEAR", testing.photo_rgbaf16(w, h)))}
    rgb_imgs["YUV444_10 HLG"] = (
        yuv_img, fused._api0_yuv444_10_block_buffers,
        [np.asarray(p, np.uint16) for p in yuv_img.planes[:3]],
        dict(rng=port.ColorRange(yuv_img.range)),
        fused.encode_api0_yuv444_10_fused)
    rgb_outputs = {}
    zero_counts()
    for rname, (rimg, *_) in rgb_imgs.items():
        for cfg, kw in configs.items():
            rgb_outputs[rname, cfg] = [
                encode(rimg, kw, f"{rname} {cfg} request {req}")
                for req in range(2)]
    rgb_launches = read_counts("RGB and YUV444_10 encode",
                               {"pack_scan": 2 * len(rgb_outputs)})
    for (rname, cfg), datas in rgb_outputs.items():
        if datas[0] != datas[1]:
            raise AssertionError(f"{rname} {cfg}: the two requests differ")
        rimg, block_buffers, planes, bb_kw, encode_fn = rgb_imgs[rname]
        check_encode(datas[0], rimg, configs[cfg], block_buffers, planes,
                     encode_fn, f"{rname} {cfg}", **bb_kw)

    # small images: the card against the port's CPU encode (which the CPU
    # tests hold against the JAX package), SDR and gain-map u8 planes within
    # 1 LSB on at most 1e-3 of the samples (RGB: and at least one, as its
    # benchmark-configuration map has only 512)
    def close_u8(a, b, what, at_least: int = 0):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if diff.max() > 1 or (diff > 0).sum() > max(at_least,
                                                    1e-3 * diff.size):
            raise AssertionError(f"{what}: card vs CPU u8 planes differ "
                                 f"(max {diff.max()}, share "
                                 f"{(diff > 0).mean():.2e})")

    small = testing.photo_p010(130, 66)
    for cfg, kw in configs.items():
        planes = {}
        for d in ("cuda", "cpu"):
            y, uv = fused.upload_p010(small, torch.device(d))
            hdr = pixel.unpack_p010(y, uv, port.ColorRange.FULL,
                                    small.h, small.w)
            y8, u8, v8 = tonemap.tonemap_to_yuv(hdr, Fmt.P010, CG.BT2100,
                                                CT.HLG)
            sdr = pixel.unpack_yuv8(y8, u8, v8, 2, 2, small.h, small.w)
            gm = gainmap.generate_gainmap_onepass(
                sdr, hdr, sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010,
                sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100, ct=CT.HLG,
                scale=kw["scale"], multichannel=kw["multichannel"],
                gamma=1.0, use_luminance=False, sdr_is_601=False,
                use_base_cg=False, max_boost=1000.0 / 203.0)
            planes[d] = [p.cpu().numpy() for p in (y8, u8, v8, gm)]
        for a, b in zip(planes["cuda"], planes["cpu"]):
            close_u8(a, b, f"P010 {cfg}")
    # the 4:4:4 encodes' tone map (RGB: to RGBA8888, then P3 YCbCr;
    # YUV444_10: to YUV444) on each device, and their gain map on each
    # device from the CPU's SDR and HDR values: one u8 step of a dark SDR
    # sample moves its gain by several steps
    small_rgb = {"RGBA1010102 PQ P3": testing.photo_rgba1010102(131, 67),
                 "RGBAF16 LINEAR": testing.photo_rgbaf16(131, 67),
                 "YUV444_10 HLG": testing.photo_yuv444_10(131, 67)}
    small_rgb["RGBA1010102 PQ P3"].ct = CT.PQ
    small_rgb["RGBA1010102 PQ P3"].cg = CG.DISPLAY_P3

    def sdr_of(simg, d):
        """(SDR values, HDR values, SDR u8 planes, SDR format) of a 4:4:4
        encode's stages on device d."""
        fmt, cg, ct = Fmt(simg.fmt), CG(simg.cg), CT(simg.ct)
        if fmt == Fmt.YUV444_10:
            hdr = pixel.unpack_yuv444_10(*fused.upload_planes(
                [np.asarray(p, np.uint16) for p in simg.planes[:3]],
                torch.device(d)), port.ColorRange(simg.range))
            yuv8 = tonemap.tonemap_to_yuv(hdr, fmt, cg, ct, out_yuv420=False)
            return (pixel.unpack_yuv8(*yuv8, 1, 1, simg.h, simg.w), hdr,
                    yuv8, Fmt.YUV444)
        unpack = pixel.unpack_rgba1010102 if fmt == Fmt.RGBA1010102 \
            else pixel.unpack_rgbaf16
        hdr = unpack(fused.upload_planes(simg.planes[:1], torch.device(d))[0])
        sdr = pixel.unpack_rgba8888(tonemap.tonemap_to_rgba8888(
            hdr, fmt, cg, ct))
        return (sdr, hdr, fused._rgb_vals_to_yuv444_planes(
            sdr, CG.DISPLAY_P3), Fmt.RGBA8888)

    for rname, simg in small_rgb.items():
        fmt, cg, ct = Fmt(simg.fmt), CG(simg.cg), CT(simg.ct)
        vals, planes = {}, {}
        for d in ("cpu", "cuda"):
            sdr, hdr, yuv8, sdr_fmt = sdr_of(simg, d)
            vals[d] = (sdr, hdr)
            planes[d] = [p.cpu().numpy() for p in yuv8]
        for cfg, kw in configs.items():
            for d in ("cpu", "cuda"):
                sdr, hdr = (v.to(d) for v in vals["cpu"])
                gm = gainmap.generate_gainmap_onepass(
                    sdr, hdr, sdr_fmt=sdr_fmt, hdr_fmt=fmt,
                    sdr_cg=CG.DISPLAY_P3, hdr_cg=cg, ct=ct,
                    scale=kw["scale"], multichannel=kw["multichannel"],
                    gamma=1.0, use_luminance=False, sdr_is_601=False,
                    use_base_cg=fused._use_base_cg(CG.DISPLAY_P3, cg, False),
                    max_boost=colors.reference_display_peak_nits(ct)
                    / 203.0)
                planes[d, cfg] = gm.cpu().numpy()
            close_u8(planes["cuda", cfg], planes["cpu", cfg],
                     f"{rname} {cfg} gain map", at_least=1)
        for a, b in zip(planes["cuda"], planes["cpu"]):
            close_u8(a, b, f"{rname} SDR", at_least=1)
    log("phase 4 small images: card == CPU port within 1 LSB on <= 1e-3 of "
        "the SDR and gain-map samples, P010, RGB and YUV444_10, both "
        "configurations")

    # ---- phase 4b: the API-1..4 encodes ----------------------------------
    # API-1 takes the P010 HDR of phase 4 with the port's own tone map of
    # it as the SDR intent (YUV420, Display-P3), as the JAX package's API-1
    # benchmark row makes its input; and once per preset RGBA1010102 HDR
    # with its RGBA8888 tone map
    presets = {"REALTIME": port.EncPreset.REALTIME,
               "BEST_QUALITY": port.EncPreset.BEST_QUALITY}
    sdr_img = port.JpegR(device="cuda").tone_map(img)
    rgb_hdr = rgb_imgs["RGBA1010102 HLG"][0]
    rgb_sdr = port.JpegR(device="cuda").tone_map(rgb_hdr)
    if (Fmt(sdr_img.fmt), Fmt(rgb_sdr.fmt)) != (Fmt.YUV420, Fmt.RGBA8888):
        raise AssertionError("tone_map did not give YUV420 / RGBA8888 SDR")

    def knob_jr(kw, preset):
        return port.JpegR(device="cuda", map_dimension_scale_factor=kw[
            "scale"], use_multi_channel_gainmap=kw["multichannel"],
            preset=preset)

    def request(what: str, configure, launches: int) -> tuple[bytes, float]:
        """One UhdrEncoder request on the card, configured by `configure`;
        it must launch the pack kernel `launches` times."""
        before = pk.PACK_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = port.UhdrEncoder(device="cuda")
        configure(enc)
        data = enc.encode()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if pk.PACK_KERNEL.launches != before + launches:
            raise AssertionError(f"{what} launched the pack kernel "
                                 f"{pk.PACK_KERNEL.launches - before} "
                                 f"times, not {launches}")
        log(f"phase 4b {what}: {ms:.1f} ms, {w * h / ms / 1e3:.2f} MP/s, "
            f"{len(data)} bytes | {card}")
        return data, ms

    def api1(hdr_i, sdr_i, kw, preset):
        def configure(enc):
            enc.set_raw_image(hdr_i, port.ImgLabel.HDR)
            enc.set_raw_image(sdr_i, port.ImgLabel.SDR)
            enc.set_quality(95, port.ImgLabel.BASE)
            enc.set_preset(preset)
            enc.set_gainmap_scale_factor(kw["scale"])
            enc.set_using_multi_channel_gainmap(kw["multichannel"])
        return configure

    api1_out, api1_ms = {}, {}
    zero_counts()
    for pname, preset in presets.items():
        for cfg, kw in configs.items():
            request(f"API-1 P010+YUV420 {pname} {cfg} warm-up",
                    api1(img, sdr_img, kw, preset), 1)
            outs = [request(f"API-1 P010+YUV420 {pname} {cfg} request "
                            f"{req}", api1(img, sdr_img, kw, preset), 1)
                    for req in range(2)]
            api1_out[pname, cfg, "P010+YUV420"] = [d for d, _ in outs]
            api1_ms[pname, cfg] = [ms for _, ms in outs]
        api1_out[pname, "default", "RGBA1010102+RGBA8888"] = [request(
            f"API-1 RGBA1010102+RGBA8888 {pname} default",
            api1(rgb_hdr, rgb_sdr, configs["default"], preset), 1)[0]]
    api1_launches = read_counts("API-1 encode", {"pack_scan": len(presets)
                                                 * (3 * len(configs) + 1)})

    def check_api1(data, hdr_i, sdr_i, kw, preset, what):
        """The phase-4 checks of an API-1 file: container and ISO boosts
        (the two-pass ones from the card's own bounds), scans that decode
        to the device's coefficients, bytes equal to the plain-entropy
        encode."""
        primary, gm_jpeg, md = testing.read_jpegr(data)
        scans, want_md, _, _ = fused.api1_scans(knob_jr(kw, preset), hdr_i,
                                                sdr_i, 95)
        for f in ("max_content_boost", "min_content_boost"):
            if not np.allclose(getattr(md, f), getattr(want_md, f),
                               rtol=1e-4):
                raise AssertionError(f"{what}: ISO {f} {getattr(md, f)} != "
                                     f"{getattr(want_md, f)}")
        for jpeg, (coeffs, layout) in zip((primary, gm_jpeg), scans):
            for g, c in zip(testing.decode_scan_coeffs(jpeg, layout),
                            coeffs):
                if not np.array_equal(g, c.cpu().numpy()):
                    raise AssertionError(f"{what}: decoded scan != device "
                                         "coefficients")
        plain = fused.encode_api1_fused(knob_jr(kw, preset), hdr_i, sdr_i,
                                        95, None, pack=pk.pack_scan_plain)
        if plain != data:
            raise AssertionError(f"{what}: kernel encode != plain-entropy "
                                 "encode")
        log(f"phase 4b checks {what}: container ok ({len(primary)} + "
            f"{len(gm_jpeg)} bytes, ISO boosts {md.min_content_boost[0]:.4f}"
            f"-{md.max_content_boost[0]:.4f}), coefficients round-trip "
            f"exactly, bytes == plain-entropy encode | {card}")

    for (pname, cfg, pair), datas in api1_out.items():
        if any(d != datas[0] for d in datas):
            raise AssertionError(f"API-1 {pair} {pname} {cfg}: requests "
                                 "differ")
        hdr_i, sdr_i = (img, sdr_img) if pair == "P010+YUV420" \
            else (rgb_hdr, rgb_sdr)
        check_api1(datas[0], hdr_i, sdr_i, configs[cfg], presets[pname],
                   f"API-1 {pair} {pname} {cfg}")

    # API-2, 3 and 4 from the parts of the default BEST_QUALITY file: its
    # base as the compressed SDR (APPn segments dropped, Display-P3 given),
    # its gain map (with its ICC profile: the map's application space is
    # the HDR's) and metadata for API-4.  Their gain maps go through the
    # general path's host entropy coder: no pack launch
    api1_file = api1_out["BEST_QUALITY", "default", "P010+YUV420"][0]
    primary, gm_jpeg, api1_md = testing.read_jpegr(api1_file)
    sdr_jpeg = testing.without_app_segments(primary)
    gm_in = testing.without_app_segments(gm_jpeg, keep_icc=True)
    comp = port.CompressedImage(sdr_jpeg, CG.DISPLAY_P3)

    def api2(enc):
        enc.set_raw_image(img, port.ImgLabel.HDR)
        enc.set_raw_image(sdr_img, port.ImgLabel.SDR)
        enc.set_compressed_image(comp, port.ImgLabel.SDR)

    def api3(enc):
        enc.set_raw_image(img, port.ImgLabel.HDR)
        enc.set_compressed_image(comp, port.ImgLabel.SDR)

    def api4(enc):
        enc.set_compressed_image(comp, port.ImgLabel.BASE)
        enc.set_gainmap_image(port.CompressedImage(gm_in), api1_md)

    zero_counts()
    compressed_out = {name: request(f"{name} (default configuration, "
                                    "BEST_QUALITY)", configure, 0)[0]
                      for name, configure in (("API-2", api2),
                                              ("API-3", api3),
                                              ("API-4", api4))}
    compressed_launches = read_counts("API-2/3/4 encode", {})
    jr_d = port.JpegR(device="cuda")
    for api, data in compressed_out.items():
        out_primary, out_gm, md = testing.read_jpegr(data)
        if testing.without_app_segments(out_primary) != sdr_jpeg:
            raise AssertionError(f"{api}: primary image != the compressed "
                                 "SDR")
        if api == "API-4":
            if testing.without_app_segments(out_gm, keep_icc=True) != \
                    gm_in or not \
                    np.allclose(md.max_content_boost,
                                api1_md.max_content_boost, rtol=1e-6):
                raise AssertionError("API-4: gain map or metadata != input")
            log(f"phase 4b checks API-4: primary and gain-map images "
                f"byte-equal to the inputs, metadata kept | {card}")
            continue
        sdr_i = sdr_img
        if api == "API-3":
            planes, fmt = jpeg_decoder.decode_to_planes(sdr_jpeg, None, dev)
            sdr_i = port.RawImage(fmt, CG.DISPLAY_P3, CT.SRGB,
                                  port.ColorRange.FULL, w, h, planes)
            on_cpu, _ = jpeg_decoder.decode_to_planes(
                sdr_jpeg, None, torch.device("cpu"))
            for p_card, p_cpu in zip(planes, on_cpu):
                if not torch.equal(p_card.cpu(), p_cpu):
                    raise AssertionError("API-3: SDR planes decoded on the "
                                         "card != on the CPU")
        gm_img, want_md = jr_d.generate_gainmap(
            sdr_i, img, sdr_is_601=api == "API-3", use_luminance=True)
        if testing.without_app_segments(out_gm) != \
                testing.without_app_segments(jr_d.compress_gainmap(gm_img)):
            raise AssertionError(f"{api}: gain-map JPEG != the general "
                                 "path's on the card")
        if not np.allclose(md.max_content_boost, want_md.max_content_boost,
                           rtol=1e-4):
            raise AssertionError(f"{api}: ISO boost {md.max_content_boost}"
                                 f" != {want_md.max_content_boost}")
        log(f"phase 4b checks {api}: primary image == the compressed SDR, "
            f"gain-map JPEG == the general path's on the card, ISO boosts "
            f"{md.min_content_boost[0]:.4f}-{md.max_content_boost[0]:.4f}"
            + (", SDR planes decoded on the card == on the CPU"
               if api == "API-3" else "") + f" | {card}")

    # small images: API-1's base planes and gain map on the card against
    # the port's CPU stages, both presets and configurations
    small_hdr = testing.photo_p010(130, 66)
    small_sdr = port.JpegR(device="cpu").tone_map(small_hdr)
    small_sdr.cg = CG.BT709          # so that the YUV re-encoding is real
    for (pname, preset), (cfg, kw) in itertools.product(presets.items(),
                                                        configs.items()):
        planes = {}
        for d in ("cuda", "cpu"):
            dv = torch.device(d)
            hdr_v = pixel.unpack(small_hdr, dv)
            sdr_v = pixel.unpack(small_sdr, dv)
            base = fused._convert_yuv_encoding_planes(
                fused.upload_planes(small_sdr.planes, dv), Fmt.YUV420,
                CG.BT709, CG.DISPLAY_P3, small_hdr.h, small_hdr.w)
            common = dict(sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010,
                          sdr_cg=CG.BT709, hdr_cg=CG.BT2100, ct=CT.HLG,
                          scale=kw["scale"], multichannel=kw["multichannel"],
                          use_luminance=True, sdr_is_601=False,
                          use_base_cg=False)
            if preset == port.EncPreset.REALTIME:
                gm = gainmap.generate_gainmap_onepass(
                    sdr_v, hdr_v, gamma=1.0, max_boost=1000.0 / 203.0,
                    **common)
            else:
                gains, gmin, gmax = gainmap.gainmap_float_pass(
                    sdr_v, hdr_v, **common)
                lo, hi = fused.api1_bounds(knob_jr(kw, preset), gmin, gmax)
                gm = gainmap.encode_gainmap_twopass(gains, lo, hi, 1.0)
            planes[d] = [p.cpu().numpy() for p in (*base, gm)]
        for a, b in zip(planes["cuda"], planes["cpu"]):
            close_u8(a, b, f"API-1 {pname} {cfg}", at_least=1)
    log("phase 4b small images: API-1 base planes (BT.709 -> BT.601 YUV) "
        "and gain maps on the card == CPU port within 1 LSB on <= 1e-3 of "
        "the samples, both presets and configurations")

    # ---- phase 5: the decode path ----------------------------------------
    outs = (CT.HLG, CT.PQ, CT.LINEAR)
    fmt_of = {CT.HLG: Fmt.RGBA1010102, CT.PQ: Fmt.RGBA1010102,
              CT.LINEAR: Fmt.RGBAF16}
    decoded = {}
    zero_counts()
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
                f"{Fmt(img_out.fmt).name} | {card}")
    apply_launches = read_counts("decode", {"apply_gainmap": 6})

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
        s_cg = CG(sdr_cg)
        if s_cg == CG.UNSPECIFIED:
            s_cg = CG.BT709
        h_cg = CG(gm_cg)
        if h_cg == CG.UNSPECIFIED:
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
                              f"apply kernel at 4K {cfg} {ct.name}"),
                bit_identical(ak.APPLY_KERNEL(sdr_yuv, gain, rows, weight,
                                              **kw_a), k_out,
                              f"apply kernel at 4K {cfg} {ct.name}, run "
                              "twice"))
            plain_ms = cuda_ms(lambda: ak.apply_gainmap_plain(
                sdr_yuv, gain, rows, weight, **kw_a), 5)
            ker_ms = cuda_ms(lambda: ak.APPLY_KERNEL(
                sdr_yuv, gain, rows, weight, **kw_a), 20)
            ker_ms2 = cuda_ms(lambda: ak.APPLY_KERNEL(
                sdr_yuv, gain, rows, weight, **kw_a), 20)
            plain_ms2 = cuda_ms(lambda: ak.apply_gainmap_plain(
                sdr_yuv, gain, rows, weight, **kw_a), 5)
            moved = nbytes(sdr_yuv, gain, k_out)
            # ~150 float operations a pixel: YUV->RGB, the sRGB LUT grid,
            # gamut, a pow and an exp2 per gain channel, the OETF, packing
            b_ms, b_by = bound(moved, 150 * w * h)
            apply_rows[cfg, ct] = dict(ms=(ker_ms + ker_ms2) / 2,
                                       plain_ms=(plain_ms + plain_ms2) / 2,
                                       bound_ms=b_ms, bound_by=b_by)
            log(f"phase 5 checks {cfg} {ct.name}: decode == plain apply on "
                f"its stage outputs, kernel == plain, bit-identical, kernel "
                f"the same run twice | apply "
                f"kernel at {w}x{h}, {gain.shape[0]}-channel gain: kernel "
                f"{ker_ms:.3f}/{ker_ms2:.3f} ms ({moved / ker_ms / 1e6:.0f} "
                f"GB/s of {moved / 1e6:.0f} MB), plain {plain_ms:.3f}/"
                f"{plain_ms2:.3f} ms (CUDA events), bound {b_ms:.4f} ms "
                f"({b_by}) | {card}")

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

    # ---- phase 6: the block-pack and tile-pack routes -------------------
    # on the P010 scans of phase 4, one launch of their kernel per
    # configuration
    route_launches = {}
    for kname, route in (("pack_blocks", testing.pack_scans_v1),
                         ("pack_tiles", testing.pack_scans_v2)):
        zero_counts()
        routed = {cfg: route(p010_scans[cfg]) for cfg in configs}
        torch.cuda.synchronize()
        route_launches[kname] = read_counts(
            f"{kname} route", {kname: len(configs)})[kname]
        for cfg, (words, blen) in routed.items():
            (_, bl), (_, gl) = p010_scans[cfg]
            blen_h = blen.cpu().numpy().astype(np.uint16)
            n_base = bl.mcus_h * bl.bpr
            joined = fused.fetch_blocks_multi(
                words.cpu().numpy().view(np.uint32),
                [(blen_h[:n_base], bl.bpr), (blen_h[n_base:], gl.bpr)])
            if joined != [testing.scan_data(j) for j in p010_jpegs[cfg]]:
                raise AssertionError(f"{kname} route {cfg}: joined scans != "
                                     "the encode's scans")
            log(f"phase 6 {kname} route {cfg}: {blen.numel()} blocks, "
                f"{words.numel()} words, joined scans == the JPEG_R's scans")

    route_rows = {}
    for cfg in configs:
        pays, lens = testing.scans_slots(p010_scans[cfg])
        n = pays.shape[0]
        budget = device_entropy._default_budget(n)
        for kname, kern, plain, extra in (
                ("pack_blocks", pk.PACK_BLOCKS_KERNEL, pk.pack_blocks_plain,
                 ()),
                ("pack_tiles", pk.PACK_TILES_KERNEL, pk.pack_tiles_plain,
                 (budget,))):
            out = kern(pays, lens, *extra)
            held, how = (tiles_equal, "torch.equal on the live prefixes") \
                if kname == "pack_tiles" else (tensors_equal, "torch.equal")
            err = held(out, plain(pays, lens, *extra), f"{kname} at 4K {cfg}")
            plain_ms = cuda_ms(lambda: plain(pays, lens, *extra), 5)
            alone_ms = testing.slot_pack_kernel_ms(kern, pays, lens, *extra)
            ker_ms = cuda_ms(lambda: kern(pays, lens, *extra), 20)
            ker_ms2 = cuda_ms(lambda: kern(pays, lens, *extra), 20)
            alone_ms2 = testing.slot_pack_kernel_ms(kern, pays, lens, *extra)
            plain_ms2 = cuda_ms(lambda: plain(pays, lens, *extra), 5)
            # ~6 operations per slot (shift, or, add, compare, store); the
            # tile pack writes only each tile's live words
            moved = nbytes(pays, lens, *out) if kname == "pack_blocks" \
                else nbytes(pays, lens, out[1]) + live_tile_bytes(*out)
            b_ms, b_by = bound(moved, 6 * pays.numel())
            route_rows[kname, cfg] = dict(
                ms=(ker_ms + ker_ms2) / 2,
                kernel_ms=(alone_ms + alone_ms2) / 2,
                plain_ms=(plain_ms + plain_ms2) / 2, err=err, bound_ms=b_ms,
                bound_by=b_by)
            log(f"phase 6 {kname} {cfg} at {n} blocks: kernel == plain "
                f"({how}), kernel alone {alone_ms:.4f}/{alone_ms2:.4f} ms "
                f"({moved / alone_ms / 1e6:.0f} GB/s of {moved / 1e6:.1f} "
                f"MB), wrapper {ker_ms:.4f}/{ker_ms2:.4f} ms, plain "
                f"{plain_ms:.3f}/{plain_ms2:.3f} ms (CUDA events), bound "
                f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / alone_ms:.0f}% of "
                f"the kernel alone) | {card}")

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "libultrahdr_tpu."))
              or m == "libultrahdr_tpu"]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

    # ---- phase 7: records -------------------------------------------------
    src, tpu = "libultrahdr_tpu_torch/csrc/", "libultrahdr_tpu/"

    def record(kname, source, replaces, launches, row, err):
        return {"name": kname, "route": "cuda", "source": src + source,
                "replaces": tpu + replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "kernel_ms": row.get("kernel_ms"),
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    log(json.dumps({"kernels": [
        record("pack_scan", "pack_kernel.cu", "jpeg/pack_kernel.py:595",
               p010_launches["pack_scan"] + rgb_launches["pack_scan"]
               + api1_launches["pack_scan"]
               + compressed_launches["pack_scan"],
               kernel_rows["default"],
               max(r["err"] for r in kernel_rows.values())),
        record("pack_blocks", "block_pack_kernel.cu",
               "jpeg/pack_kernel.py:121", route_launches["pack_blocks"],
               route_rows["pack_blocks", "default"],
               max(r["err"] for (k, _), r in route_rows.items()
                   if k == "pack_blocks")),
        record("pack_tiles", "block_pack_kernel.cu",
               "jpeg/pack_kernel.py:260", route_launches["pack_tiles"],
               route_rows["pack_tiles", "default"],
               max(r["err"] for (k, _), r in route_rows.items()
                   if k == "pack_tiles")),
        record("apply_gainmap", "apply_kernel.cu", "ops/pallas_apply.py:177",
               apply_launches["apply_gainmap"],
               apply_rows["default", CT.HLG], apply_err)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
