#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py [--previous-wire-kernel PATH]

(PATH: a copy of the parent commit's ``csrc/wire_kernel.cu`` made outside
the checkout, whose two kernels phase 18d then times beside the current
ones.)  Drives the port's paths at 3840x2160: the API-0 encode of P010 (one
request at a time and pipelined), RGBA1010102 and RGBAF16 input through
``libultrahdr_tpu_torch.UhdrEncoder(device="cuda")`` and of YUV444_10 input
through ``JpegR(device="cuda").encode_api0``, the API-1 encode (raw HDR +
raw SDR, both presets) and one API-2, API-3 and API-4 encode through
``UhdrEncoder``, the JPEG_R decode of the P010 files through
``UhdrDecoder(device="cuda")`` (HLG, PQ, LINEAR and SRGB) and through the
batched and microbatched ``decode_to_device``, the general decode path
(fractional and resized gain maps, a grayscale and a progressive base,
``use_fused=False``), the host decode engine ``JpegR.decode_host``,
the slot-input block-pack and tile-pack routes on the encode's scans, and
(at 256x160) the reference library's own files and inputs, in phases that
each
print lines and let any failure propagate (exit code != 0).  Every path is
driven with all kernel launch counts set to 0 just before it and read just
after (the scan kernel's too: two launches a fused encode, one a plane of
the general path's encoder), and every scan and plane it built is then
held against the plain composition on its own inputs:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the eight CUDA kernel libraries (csrc/pack_kernel.cu,
   csrc/block_pack_kernel.cu, csrc/apply_kernel.cu, the scan kernel
   csrc/dct_kernel.cu, the wire kernels csrc/wire_kernel.cu, the stitch
   csrc/stitch_kernel.cu, the entropy decode csrc/huffman_kernel.cu and
   the restart-row join csrc/join_kernel.cu, nvcc, sm_90a) and the host
   C++ (csrc/host/) from the checkout's sources, the compilers started
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
   packed outputs must be bit-identical; and the scan kernel against
   ``dct.scan_inputs_plain`` on 4:2:0, 4:4:4, RGB 4:4:4 and 4:0:0 scans
   (one MCU, 31 and 32 MCUs, phase 3's MCU grids with ragged edges, flat
   planes at quality 100 and 1, column and row slices), two scans back to
   back and planes through ``forward_plane``, torch.equal;
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
   encode.  Prints each request's ms and MP/s, the pack kernel's (alone
   and through its wrapper) and its plain version's time at the 4K shapes
   (CUDA events) beside its bound, and the scan kernel's on the request's
   two scans (alone and through ``dct.scan_inputs``), the plain
   composition's, and the kernel's on the luma plane alone, beside their
   bounds;
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
4c. the fused gain map's clipped gains (the JAX package's compiled fused
   programs code a clipped HLG gain 254, ``gainmap.encode_gain_folded``):
   prints the float32 bits of log(max boost) on the CPU and the card (HLG,
   PQ); encodes ``testing.photo_p010`` seeds 4, 6 and 8 (HLG) and a photo
   with a band of bright, saturated patches (HLG and PQ) at 3840x2160
   through ``UhdrEncoder`` in both configurations, one pack launch each;
   then holds the fused route's map (``fused._onepass_gainmap``) on the
   card, from the CPU's SDR planes, against the CPU's: every clipped
   sample's code equal (HLG 254, PQ 255), the rest within 1 LSB on at most
   1e-3 of the samples, and the SDR planes within the same contract.
   Prints the clipped counts and codes and the phase's seconds;
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
7. the pipelined encode (``fused.encode_api0_p010_pipelined``) of eight 4K
   ``photo_p010`` images (eight seeds) per configuration, twice: one pack
   launch an image, every file equal to the single-image encode of its
   image on the card (which runs after it, one request at a time); prints
   both runs' ms and MP/s beside the loop's;
8. ``JpegR.decode_to_device_batch`` over phase 7's eight files, the
   benchmark configuration's to HLG and the default's to LINEAR: one apply
   launch a stream, every output bit-identical to the per-image route
   (``decode_to_device(..., microbatch=False)``) on the card; prints the
   batch's and the per-image loop's ms and MP/s;
9. four ``decode_to_device`` callers on four threads, coalesced by the
   microbatcher into one batch dispatch (counted; no retry), four apply
   launches, each output bit-identical to the per-image route;
10. one RGBA8888 / SRGB decode per configuration through ``UhdrDecoder`` on
   the card (no kernel launch), its image and gain map equal to the same
   decode on CPU tensors, and two on the host SRGB engine
   (``UHDR_TPU_DECODE_ENGINE=host``; equal to ``decode_to_rgba(engine=
   "host")``, within 2 codes of the card's); prints their ms;
12. the general decode path at 4K, each request through
   ``UhdrDecoder(device="cuda")`` (or ``JpegR.decode(use_fused=False)``):
   API-0 files at map scale 7 (a 548x308 map, factor 7.007: the float-
   factor IDW) with 1 and 3 channels to HLG and LINEAR; an API-4 file of
   the benchmark file's base and its gain map cropped to 960x480 (the
   host bicubic resize) to PQ; an API-4 file with a YUV400 base (the
   base's luma) to HLG; the committed progressive fixture
   (``tests/data/progressive_jpegr_3840x2160.jpg``) to HLG and SRGB;
   phase 4's two files with ``use_fused=False`` to HLG.  Each HDR request
   launches the apply kernel exactly once (SRGB: never) and is
   bit-identical to the plain apply on the card run on its own stage
   outputs (``JpegR._general_planes`` and ``_apply_inputs``); the
   fixture's planes on the card equal ``inverse_plane`` on CPU tensors and
   its HLG decode the CPU port's within ``check_decoded_close``; a small
   image of each other kind decoded on the card is within
   ``check_decoded_close`` of the CPU port's.  Prints each request's ms
   and MP/s, its host stages timed alone (parse, Huffman, resize), and the
   apply kernel's and plain version's time on the float fractional gain
   and on the resized map;
13. ``JpegR.decode_host`` of phase 4's two files to HLG and LINEAR on the
   host, twice, beside the card's ``UhdrDecoder`` decode of the same file
   (one apply launch): >= 55 dB a channel against it, the JAX package's
   host-vs-device gate; prints both times; and ``UhdrDecoder`` with
   ``UHDR_TPU_DECODE_ENGINE=host`` equals ``decode_host`` with no launch;
14-16. effects on the card (``UhdrDecoder`` effect queues, device effects,
   encodes with effects), AGTM, and the public API modules (JpegRCompat,
   the CLI, the C-ABI bridge), each checked against the direct route;
17. the batch and multi-GPU layer (``parallel``) over meshes that repeat
   the card (and over distinct cards where there are several):
   ``sharded_encode_jpeg_step`` of ``photo_p010(8192, 4608)`` over (1, 4)
   in both configurations, four pack launches and eight scan-kernel
   launches each (every shard's scans equal to the plain composition), its
   assembled base scan (at scale 1 also the gain-map scan and the file, which
   ``JpegR.decode`` reads) byte for byte the single-device ones;
   ``sharded_encode_step`` one-pass (bit-identical) and two-pass (map within
   1, bounds within 1e-6 relative) over (2, 2) with two 4K images and over
   (1, 4) with the 8K one against ``encode_core_p010`` / ``_twopass`` of
   each image, and ``encode_batch_p010`` against them; ``sharded_apply_step``
   over (1, 4) at 8K, scale 1 and 4, 1 and 3 channels, HLG and LINEAR,
   four apply launches each, bit-identical to the single-device apply; and
   ``decode_to_device_batch(mesh=make_mesh(4, 1, ...))`` of phase 7's
   files, eight apply launches, bit-identical to the per-image route.
   Prints each step's ms beside the single-device route's;
18. the wire codecs (``wire.py``), which every phase above leaves off (no
   knob set: 0 launches of the two wire kernels on every path): 18a the
   un-slicing kernel and the download-pack kernel against their plain
   versions (torch.equal) on edge cases (fixed rungs of 2-8 bits, vw widths
   0-15, sample counts that are no multiple of 32, a payload shorter than
   its offsets; both download formats at 3, 4, 6 and 8 bits, escapes at the
   first and last sample, counts above cap) and at the seams of the
   kernels' CTA runs and tiles (``testing.unslice_edge_cases``,
   ``testing.down_pack_edge_cases``, each input at its alignment); 18b 4K
   encodes with
   ``UHDR_TPU_WIRE`` = auto, vw, 2d5, 1d7 (P010), auto (RGBA1010102,
   RGBAF16) and ``UHDR_TPU_WIRE_API1`` = auto, h4s3 (API-1, both presets),
   both configurations, each file byte-identical to the raw route's of
   phases 4 and 4b and naming the wire it rode (``wire.RODE``), and the
   pipelined encode over phase 7's images, each on its own wire
   (``UHDR_TPU_WIRE`` = auto, vw, with ``UHDR_TPU_BATCH_K=1``: phase 22
   runs the K-batches), equal to phase 7's files; 18c the
   4K decodes of both files to HLG and LINEAR with ``UHDR_TPU_WIRE`` = auto
   (the coefficient wire) and ``UHDR_TPU_WIRE_DOWN`` = auto, 4, 8, each
   equal to phase 5's raw output, and phase 8's batch decodes over the
   coefficient wire equal to phase 8's per-image outputs; each path's wire
   kernel launches as its wires imply; 18d times, each route beside raw in
   turns (host clock medians: request, host pack, upload; the download
   against ``.cpu()``) and the kernels by CUDA events beside their bounds
   (the un-slice on the P010 vw wire, an RGBA1010102 channel's 4-bit rung
   and the i4 coefficient rung of the luma plane; the download pack on the
   decoded and on smooth 4K outputs, HLG 4 bits and LINEAR 8 bits, its
   three launches split by ``torch.profiler``), each alone in turns with
   the previous design when ``--previous-wire-kernel`` names it;
19. the C ABI (``libultrahdr_tpu_torch/capi/ultrahdr_tpu.h``) on the card,
   ``UHDR_TPU_TORCH_DEVICE`` unset: (a) the walkthrough ``test_capi.c`` and
   ``capi_roundtrip`` of phase 4's 4K P010 in both configurations (the
   default's also from two C threads), each a process of its own on the
   shim linked against libpython: exit 0, each file byte for byte phase 4's
   ``UhdrEncoder`` file, each HLG / LINEAR decode phase 5's output; prints
   the first call's cost (the embedded interpreter's start and imports,
   the first encode); (b) the shim built for a running interpreter, loaded
   here with ``ctypes.CDLL`` (``capi/abi.py``): both configurations encoded
   and decoded to HLG and LINEAR through the C functions, one pack and two
   scan-kernel launches an encode, one apply launch a decode, every result
   equal to the direct call's; two Python threads encoding through their
   own handles, equal files; each request beside the direct
   ``UhdrEncoder`` / ``UhdrDecoder`` call in turns (medians of 3 after a
   warm-up);
20. the hardening gates: (a) ``tools/sanitize_kernels.py`` (every kernel
   through its wrapper on phase 3's and 18a's edge cases, and memcheck's
   and the guards' also at the 4K default shapes, each output torch.equal
   to its plain version) in children under ``compute-sanitizer`` (from
   nvcc's ``bin/``) with memcheck, racecheck, synccheck and initcheck,
   PyTorch's caching allocator off: a tool's report of any error, a child's
   failure or a missing binary fails the phase; a tool that refuses the
   device ("Device not supported", before any kernel runs) is printed as
   refused, and then the guard runs stand in for it: the guard-page
   allocator (``tools/guard_alloc.cpp``: an unmapped granule after, then
   before, every tensor, new memory filled with 0xA5, then 0x5A) and eight
   runs of each small case beside a busy stream, each child's per-kernel
   cases, launches and seconds printed; (b) ``fuzz/differential.py`` in a
   child: 2,000 seeded mutants of small CPU-encoded JPEG_R files decoded
   through ``UhdrDecoder(device="cuda")`` and on the CPU to HLG and
   LINEAR, the same verdict (an output or a coded ``UhdrError``; anything
   else, a CUDA error above all, fails) and outputs within
   ``testing.check_decoded_close``; prints accepted, rejected and ms a
   mutant, adds the child's apply launches to the records, then decodes
   phase 4's two files again, equal to phase 5's outputs;
21. the benchmark tools in this process: ``tools/benchmarks.py`` (the
   reference benchmark's matrix: every section at 3840x2160, 3 reps, each
   row's outputs checked) and ``tools/bench.py`` (the headline pipelined
   encode, every file == ``encode_api0``, and its extras); each row and the
   headline printed on a line of its own; any failed check fails the
   phase, and so does a row whose launches differ from phases 4-5's (one
   pack and two scan-kernel launches a fused encode, one apply launch an
   HLG/PQ/LINEAR decode on the card, none on SRGB or the host engine);
22. the K-batch route of the pipelined encode (``fused._batches``,
   ``fused._dispatch_batch``): 22a the stitch kernel
   (``csrc/stitch_kernel.cu``) against its plain version (torch.equal on
   the live words) on ``testing.stitch_edge_cases`` (k = 1, images of 0
   live words, odd counts, every total mod 4, 64 images); 22b the 8 rolled
   4K photos of ``tools/bench.py`` (its benchmark configuration) with
   ``UHDR_TPU_WIRE=vw`` at the default chunk bytes (K = 2), with
   ``UHDR_TPU_CHUNK_BYTES=1e9`` (K = 8), over the 1d7 rung (each photo
   overflows its escapes and goes up alone, over the dense 10-bit pack)
   and with a non-uniform image (PQ) breaking a batch, and 8 rolled 4K
   mosaics over the 2d6 rung (K = 2), each file equal to its single
   ``encode_api0`` on the card, the launches as the batches imply (one
   stitch a batch, one pack and two scan-kernel launches an image, the
   un-slices as ``wire.RODE`` counts), and the stitch of the K = 8 batch at
   4K against its plain version on the slot's own rows; 22c ms an image of
   the K-batch route (K = 2, 8), the per-image wire route
   (``UHDR_TPU_BATCH_K=1``) and the raw pipelined route, in turns, and the
   stitch alone by CUDA events beside its bound;
23. reference interop on the card, over the 8 files of ``tests/goldens/``
   (written once by the reference library: libjpeg-turbo's baseline
   streams without restart markers, ISO or XMP metadata) at their own
   256x160: (a) each reference JPEG_R through ``UhdrDecoder(device="cuda")``
   to HLG, PQ, LINEAR and SRGB, ``JpegR.decode_to_device`` microbatched and
   per-image, ``JpegR.decode_host`` and the general path
   (``use_fused=False``), and all 8 through one ``decode_to_device_batch``
   (mixed configurations): each output >= 60 dB against the reference's own
   raster and within ``testing.check_decoded_close`` of the port's CPU
   decode of the same bytes (SRGB equal; the host engine >= 55 dB a
   channel against the card's decode, the JAX package's host-vs-device
   gate), the device-resident routes equal to ``UhdrDecoder``'s; (b) each
   golden's raw input (P010, RGBA1010102, RGBAF16) encoded by
   ``UhdrEncoder(device="cuda")`` at the golden's configuration and metadata
   kind, its card decode >= 48 dB against the reference's decode and no
   more than 12 dB below the anchor (capped at 60 dB), the file equal to
   the port's CPU encode of the same input (or each JPEG's scan equal where
   its coefficients are, the others within 1 in at most 64 blocks of each
   1,000 samples' worth); (c) the effects golden's 9 queues through the
   host editor (``UhdrDecoder``, SRGB and HLG) and through
   ``decode_to_device(effects=...)``, at the CPU tests' gates.  Every apply
   and pack launch of the phase is recorded with its inputs and held
   against its plain version (bit-identical; the pack's live words and
   block lengths), every scan it builds against the plain composition.
   Prints a line a file and route (PSNR, route, launches, seconds), one an
   encode, one an effect queue;
24. the entropy decode of scans without restart markers on the card
   (``jpeg/huffman_kernel``): (a) the kernel against its plain version (run
   on the card's tensors) and ``native.decode_scan`` on
   ``testing.huffman_edge_cases`` and the goldens' bases and maps at
   64-bit subsequences, and the same status word as the plain version on
   ``huffman_fault_cases``; (b) the base and the map of a 12 MP file of each
   benchmark configuration (the plain writer's, no DRI): kernel == plain ==
   host, the kernel's ms (CUDA events), the plain version's and the host's
   beside its bound, and each of its kernels' device ms in one decode
   (torch.profiler, in a child process: ``--huffman-split``); (c)
   ``UhdrDecoder.decode`` of those files to HLG and PQ: two launches a
   request, read from counts zeroed before it (the kernel's record counts
   these and phase 23's), no re-decode, output and map == the host
   route's; (d) a card fuzz of seeded bit flips in the goldens' scans
   through the fused route: every output and map == the host route's, the
   re-decodes counted.  ``--only-huffman`` runs phase 1's card line and this
   phase alone;
25. the restart-row join of the fused encodes on the card
   (``jpeg/join_kernel``): (a) the kernel, run twice, against its plain
   version on the card's tensors and ``native.join_blocks`` on
   ``testing.join_edge_cases``; (b) a request of each benchmark encode cell
   (``android_12mp.encode_c1``, 12 MP; ``libdefault_8k.encode_api0_c1``,
   8192x4320) through the harness's ``UhdrEncoder``: one join launch, the
   file's scans == the kernel's == the plain version's ==
   ``native.join_blocks`` on the request's pack output (the pack's whole
   room, as the route hands it over); the kernel's time alone (CUDA
   events) beside its bound (the live words and block lengths read, the
   scans written), the wrapper's, the plain version's and the host join's
   (host clock).  The join is in the launch counts of every path: once a
   fused encode, never on the pipelined, K-batch and sharded routes,
   which join on the host.  ``--only-join`` runs phase 1's card line, the
   kernel's build (its ptxas lines) and this phase alone;
11. (printed last) one JSON line with the kernel records (launches on the paths,
   the apply kernel's HLG/PQ and LINEAR branches apart, as the TPU
   kernel's two ``pallas_call`` lines, max abs error against the plain
   version, ms through the wrapper, the launch alone as kernel_ms for the
   three pack kernels (null for the apply, whose wrapper is one launch),
   plain ms, the bound), then the device line.

It imports nothing of JAX and nothing of the JAX package; there is no CPU
path.  No wire knob (UHDR_TPU_WIRE, UHDR_TPU_WIRE_API1, UHDR_TPU_WIRE_DOWN)
may be set in its environment: phase 18 sets them itself.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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


def previous_wire_kernels(source: pathlib.Path):
    """The previous design of the two wire kernels, built from `source` (a
    copy of the parent commit's ``csrc/wire_kernel.cu`` made outside the
    checkout, which holds only the current one) into ``_build/``: (unslice,
    down_pack), callables with the current wrappers' arguments and results
    that launch it on the current stream.  That design's download pack
    takes an int32 scratch of three counts a CTA of 8,192 samples."""
    import ctypes
    import torch
    from libultrahdr_tpu_torch import _buildlib
    from libultrahdr_tpu_torch.ops import wire_kernel as wk
    lib, _, _ = _buildlib.build_cuda("wire_kernel_previous", source)
    for fn, argtypes in wk.WIRE_LIB.signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def unslice(payload, n, *, bits=0, widths=None, offsets=None):
        g = -(-n // 32) if widths is None else widths.numel()
        out = torch.empty(n, dtype=torch.int32, device=payload.device)
        _buildlib.check_launch(lib, lib.uhdr_wire_unslice(
            payload.data_ptr(), payload.numel(),
            None if widths is None else widths.data_ptr(),
            None if widths is None else offsets.data_ptr(), int(bits), g, n,
            out.data_ptr(), stream(payload.device)), "previous unslice")
        return out

    def down_pack(packed, *, bits, cap=wk.DOWN_ESC, base=512):
        h, w = packed.shape[:2]
        g = -(-(h * w) // 32)
        dev = packed.device
        wire = torch.empty(3 * (g * bits + 2 * cap) + 3, dtype=torch.int32,
                           device=dev)
        scratch = torch.empty(3 * max(1, -(-g * 32 // 8192)),
                              dtype=torch.int32, device=dev)
        _buildlib.check_launch(lib, lib.uhdr_down_pack(
            packed.data_ptr(), int(packed.dim() == 3), h, w, int(bits),
            int(cap), int(base), wire.data_ptr(), scratch.data_ptr(),
            stream(dev)), "previous down pack")
        return wire

    return unslice, down_pack


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


HUFFMAN_KERNEL_NAMES = ("unstuff_count_kernel", "unstuff_write_kernel",
                        "freeze_status_kernel", "setup_kernel", "sync_kernel",
                        "scan_kernel", "write_kernel")


def huffman_split(paths) -> dict:
    """Device ms and launches of each entropy-decode kernel in one decode
    of each JPEG at `paths` (torch.profiler, after a warm-up decode), by
    file name.  Phase 24b runs it in a child process of its own: after the
    earlier phases a profiler session in the smoke's process records no
    device time for these launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from libultrahdr_tpu_torch.jpeg import huffman_kernel as hk
    from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
    names = re.compile(r"(?<![A-Za-z_])(" + "|".join(HUFFMAN_KERNEL_NAMES)
                       + r")(?![A-Za-z_])")
    out = {}
    for path in map(pathlib.Path, paths):
        data = path.read_bytes()
        info = parse_jpeg(data)
        plan = hk.scan_plan(info)
        staged = hk.stage(data, info.scan_offset, plan).to("cuda")
        hk.decode(staged, plan)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hk.decode(staged, plan)
            torch.cuda.synchronize()
        split, keys = {}, []
        for ev in prof.key_averages():
            keys.append(ev.key[:80])
            m = names.search(ev.key)
            t = ev.self_device_time_total or ev.device_time_total
            if m and t > 0:
                n, ms = split.get(m.group(1), (0, 0.0))
                split[m.group(1)] = (n + ev.count, ms + t / 1e3)
        out[path.name] = split or {"no device time recorded": keys[:8]}
    return out


def huffman_phase(card: str) -> dict:
    """Phase 24 (the module docstring); returns the kernel's record row and
    its launches."""
    import numpy as np
    import torch
    from libultrahdr_tpu_torch import api, fused, testing
    from libultrahdr_tpu_torch.errors import UhdrError
    from libultrahdr_tpu_torch.jpeg import huffman_kernel as hk, native
    from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
    from libultrahdr_tpu_torch.jpegr import JpegR
    from libultrahdr_tpu_torch.types import ColorTransfer as CT, ImgFmt
    from uhdrbench import harness
    t24 = time.perf_counter()
    dev = torch.device("cuda")
    kern = hk.HUFFMAN_KERNEL
    spent = [-kern.launches]   # the phase's launches, across zero()

    def zero():
        """The kernel's counts set to 0 before a driven path."""
        spent[0] += kern.launches
        kern.launches = kern.host_redecodes = 0

    def prepared(data: bytes):
        info = parse_jpeg(data)
        plan = hk.scan_plan(info)
        return info, plan, hk.stage(data, info.scan_offset, plan).to(dev)

    def host(data: bytes, info):
        comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
                 for c in info.components]
        plan = hk.scan_plan(info)
        return native.decode_scan(
            data[info.scan_offset:], comps, plan.mcus_w, plan.mcus_h,
            [info.dc_tables.get(i) for i in range(4)],
            [info.ac_tables.get(i) for i in range(4)], 0)[0]

    def equal(planes, want) -> bool:
        return len(planes) == len(want) and all(
            np.array_equal(p.cpu().numpy(), w) for p, w in zip(planes, want))

    # (a) edge cases, the goldens, the faults
    goldens = {name: bytes(testing.load_golden(name)[0]["jpegr"])
               for name in testing.golden_names()}
    cases = list(testing.huffman_edge_cases())
    for name, data in goldens.items():
        primary, gm = JpegR.extract_primary_and_gainmap(data)
        cases += [(f"{name} base", primary, 64), (f"{name} map", gm, 64)]
    for name, data, bits in cases:
        info, plan, staged = prepared(data)
        got, status = hk.decode(staged, plan, sub_bits=bits)
        plain, plain_status = hk.decode_plain(staged, plan, bits)
        if int(status) or int(plain_status) or not all(
                torch.equal(a, b) for a, b in zip(got, plain)) \
                or not equal(got, host(data, info)):
            raise AssertionError(f"phase 24a {name}: status {int(status)} / "
                                 f"plain {int(plain_status)}, or planes != "
                                 "plain / host")
    faults = testing.huffman_fault_cases()
    for name, data in faults:
        _, plan, staged = prepared(data)
        status = int(hk.decode(staged, plan, sub_bits=64)[1])
        plain_status = int(hk.decode_plain(staged, plan, 64)[1])
        if not status or status != plain_status:
            raise AssertionError(f"phase 24a fault {name}: status {status}, "
                                 f"plain {plain_status}")
    log(f"phase 24a entropy decode == plain == native.decode_scan on "
        f"{len(cases)} scans ({len(cases) - 2 * len(goldens)} edge cases, "
        f"{len(goldens)} goldens' bases and maps), status == plain's and "
        f"nonzero on {len(faults)} faults | {card}")

    # (b) the benchmark's 12 MP files
    rows, files, jpegs = {}, {}, {}
    split_dir = pathlib.Path(tempfile.mkdtemp(prefix="huffman_split_"))
    for cell in ("android_12mp.decode_hlg_c1",
                 "libdefault_12mp.decode_pq_c4"):
        c, cfg = harness.load_cell(cell)
        files[cell] = harness.make_inputs(dict(c, pool=1), cfg,
                                          2 ** 31 + 11, "cuda")[0]
        for image, jpeg in zip(("base", "map"),
                               JpegR.extract_primary_and_gainmap(
                                   files[cell])):
            info, plan, staged = prepared(jpeg)
            got, status = hk.decode(staged, plan)
            t0 = time.perf_counter()
            plain, plain_status = hk.decode_plain(staged, plan)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            host_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                want = host(jpeg, info)
                host_ms.append((time.perf_counter() - t0) * 1e3)
            if int(status) or int(plain_status) or not equal(got, want) \
                    or not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"phase 24b {cell} {image}: status "
                                     f"{int(status)}, or planes != host")
            ms = cuda_ms(lambda: hk.decode(staged, plan), 20)
            key = cell.split(".")[0], image
            jpegs[key] = split_dir / f"{key[0]}_{image}.jpg"
            jpegs[key].write_bytes(jpeg)
            scan_bytes = staged.numel() - hk.HEADER_BYTES
            moved = scan_bytes + 2 * plan.blocks * 64
            row = {"ms": ms, "plain_ms": plain_ms,
                   "host_ms": float(np.median(host_ms)),
                   "bound_ms": moved / 3.35e12 * 1e3, "bound_by": "bytes",
                   "scan_bytes": scan_bytes, "blocks": plan.blocks}
            rows[key] = row
            log(f"phase 24b {cell} {image}: {scan_bytes} scan bytes, "
                f"{plan.blocks} blocks: kernel {ms:.4f} ms (bound "
                f"{row['bound_ms']:.4f} ms, {moved / 1e6:.2f} MB, "
                f"{100 * row['bound_ms'] / ms:.2f}%), plain {plain_ms:.1f} ms"
                f" on the card's tensors, host native.decode_scan "
                f"{row['host_ms']:.1f} ms (median of 3); == plain == host"
                f" | {card}")
    child = subprocess.run(
        [sys.executable, str(HERE / "chip_smoke.py"), "--huffman-split",
         *map(str, jpegs.values())], capture_output=True, text=True,
        timeout=600, cwd=HERE)
    shutil.rmtree(split_dir)
    if child.returncode:
        raise AssertionError(f"phase 24b split child: exit "
                             f"{child.returncode}: {child.stderr[-2000:]}")
    splits = json.loads(child.stdout.strip().splitlines()[-1])
    for key, path in jpegs.items():
        split = rows[key]["split"] = splits[path.name]
        text = ", ".join(f"{k} {ms:.4f} ({n})" for k, (n, ms) in sorted(
            split.items(), key=lambda kv: -kv[1][1])) \
            if "no device time recorded" not in split else str(split)
        log(f"phase 24b {key[0]} {key[1]}: device ms a kernel (launches) "
            f"in one decode, torch.profiler in a child process: {text} | "
            f"{card}")

    # (c) the public API against the host route
    def run(data, ct):
        dec = api.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_color_transfer(ct)
        dec.set_out_img_format(ImgFmt.RGBA1010102)
        out = np.asarray(dec.decode().planes[0]).copy()
        return out, np.asarray(dec.get_decoded_gainmap_image().planes[0])

    real_plan = fused.card_scan_plan
    path_launches = 0   # the public API's, read from counts zeroed before
    for cell, data in files.items():
        for ct in (CT.HLG, CT.PQ):
            zero()
            out, gm = run(data, ct)
            if kern.launches != 2 or kern.host_redecodes:
                raise AssertionError(f"phase 24c {cell} {ct.name}: "
                                     f"{kern.launches} launches, "
                                     f"{kern.host_redecodes} re-decodes")
            path_launches += kern.launches
            fused.card_scan_plan = lambda info, device: None
            try:
                ref_out, ref_gm = run(data, ct)
            finally:
                fused.card_scan_plan = real_plan
            if not (np.array_equal(out, ref_out)
                    and np.array_equal(gm, ref_gm)):
                raise AssertionError(f"phase 24c {cell} {ct.name}: output "
                                     "or map != the host route's")
    log(f"phase 24c UhdrDecoder.decode of the two 12 MP files to HLG and "
        f"PQ: 2 launches a request, no re-decode, output and map == the "
        f"host route's | {card}")

    # (d) the card fuzz through the fused route
    rs = np.random.RandomState(24)
    names = sorted(goldens)
    jr = JpegR(device="cuda")
    r0, n_mut, refused_both = kern.host_redecodes, 0, 0
    for i in range(400):
        data = bytearray(goldens[names[i % len(names)]])
        primary, gm = JpegR.extract_primary_and_gainmap(bytes(data))
        which = primary if rs.randint(2) else gm
        start = bytes(data).find(which) + parse_jpeg(which).scan_offset
        end = bytes(data).find(which) + len(which) - 2
        for _ in range(rs.randint(1, 4)):
            data[rs.randint(start, end)] ^= 1 << rs.randint(8)
        data = bytes(data)
        got = []
        for card_route in (True, False):
            if not card_route:
                fused.card_scan_plan = lambda info, device: None
            try:
                dest, _, gmi = jr.decode(data, CT.HLG, return_gainmap=True)
                got.append((np.asarray(dest.planes[0]).copy(),
                            np.asarray(gmi.planes[0]).copy()))
            except UhdrError as e:
                got.append(("error", int(e.code)))
            finally:
                fused.card_scan_plan = real_plan
        (a, b) = got
        if isinstance(a[0], str) or isinstance(b[0], str):
            if a != b:
                raise AssertionError(f"phase 24d mutant {i}: {a} vs {b}")
            refused_both += 1
        elif not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"phase 24d mutant {i}: card route's "
                                 "output != the host route's")
        n_mut += 1
    redecodes = kern.host_redecodes - r0
    log(f"phase 24d card fuzz (seed 24): {n_mut} mutants of the "
        f"{len(names)} goldens (1-3 bit flips in a scan) through JpegR."
        f"decode to HLG, card route == host route on every output and map "
        f"({refused_both} refused by both), {redecodes} decoded again on "
        f"the host after a nonzero status | {card}")
    launches = spent[0] + kern.launches
    log(f"phase 24: {launches} entropy-decode launches in all, "
        f"{path_launches} of them on the public API's path (24c); "
        f"{time.perf_counter() - t24:.1f} s | {card}")
    return {"row": rows["android_12mp", "base"], "rows": rows,
            "launches": launches, "path_launches": path_launches,
            "redecodes": redecodes}


def join_phase(card: str) -> dict:
    """Phase 25 (the module docstring); returns the kernel's record row and
    its launches on the encode cells' path."""
    import numpy as np
    import torch
    from libultrahdr_tpu_torch import fused, testing
    from libultrahdr_tpu_torch.jpeg import join_kernel as jk
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    from uhdrbench import harness
    t25 = time.perf_counter()
    dev = torch.device("cuda")
    kern = jk.JOIN_KERNEL

    def scans(out, sizes) -> list[bytes]:
        sizes = sizes.tolist()
        return jk.scan_bytes(out[:sum(sizes)].cpu().numpy(), sizes)

    # (a) the edge cases: kernel == kernel again == plain on the card's
    # tensors == the host join
    cases = testing.join_edge_cases()
    for name, w, b, parts in cases:
        wd = torch.from_numpy(w.view(np.int32)).to(dev)
        bd = torch.from_numpy(b.astype(np.int32)).to(dev)
        before = kern.launches
        got = scans(*jk.join_scans(wd, bd, parts))
        again = scans(*jk.join_scans(wd, bd, parts))
        if kern.launches != before + 2:
            raise AssertionError(f"phase 25a {name}: {kern.launches - before}"
                                 " launches for two joins")
        if not got == again == scans(*jk.join_scans_plain(wd, bd, parts)) \
                == testing.host_join(w, b, parts):
            raise AssertionError(f"phase 25a {name}: kernel, kernel again, "
                                 "plain and native.join_blocks differ")
    log(f"phase 25a join kernel == the same run again == plain (on the "
        f"card's tensors) == native.join_blocks on {len(cases)} edge cases "
        f"({', '.join(n for n, *_ in cases)}) | {card}")

    # (b) a request of each encode cell through UhdrEncoder (the harness's
    # Port): one join launch; the file's scans, the kernel's, the plain
    # version's and the host join's on the same pack output equal; the
    # kernel's time alone beside its bound, the wrapper's, the plain
    # version's and the host join's
    rows, path_launches = {}, 0
    real = fused._pack_scans
    for cell in ("android_12mp.encode_c1", "libdefault_8k.encode_api0_c1"):
        c, cfg = harness.load_cell(cell)
        item = harness.make_inputs(dict(c, pool=1), cfg, 2 ** 31 + 25,
                                   "cuda")[0]
        port = harness.Port("cuda")
        seen = []

        def keep(scans_, pack):
            out = real(scans_, pack)
            seen.append((out, [lay for _, lay in scans_]))
            return out
        fused._pack_scans = keep
        try:
            port.encode(cfg, item)                 # warm-up
            seen.clear()
            before = kern.launches
            data = port.encode(cfg, item)
            launches = kern.launches - before
        finally:
            fused._pack_scans = real
        if launches != 1:
            raise AssertionError(f"phase 25b {cell}: {launches} join "
                                 "launches in a request")
        path_launches += launches
        ((room, blen), layouts), = seen
        parts = [(lay.mcus_h * lay.bpr, lay.bpr) for lay in layouts]
        total = int(((blen.long() + 31) >> 5).sum())
        words_h = room[:total].cpu().numpy().view(np.uint32)
        blen_h = blen.cpu().numpy()
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            want = testing.host_join(words_h, blen_h, parts)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        primary, gm_jpeg, _ = testing.read_jpegr(data)
        if [testing.scan_data(primary), testing.scan_data(gm_jpeg)] != want:
            raise AssertionError(f"phase 25b {cell}: the file's scans != "
                                 "native.join_blocks on its pack output")
        if scans(*kern(room, blen, parts)) != want or scans(
                *jk.join_scans_plain(room[:total], blen, parts)) != want:
            raise AssertionError(f"phase 25b {cell}: kernel or plain != "
                                 "native.join_blocks")
        if room.numel() != blen.numel() * pk.CAP_WORDS:
            raise AssertionError(f"phase 25b {cell}: the join did not read "
                                 "the pack's room")
        bufs = kern.buffers(room, parts)
        alone = [testing.launch_ms(
            lambda: kern.launch(room, blen, parts, *bufs)) for _ in range(2)]
        wrapper = cuda_ms(lambda: kern(room, blen, parts), 20)
        plain_ms = cuda_ms(
            lambda: jk.join_scans_plain(room[:total], blen, parts), 3)
        out_bytes = sum(len(x) for x in want)
        moved = 4 * total + nbytes(blen) + out_bytes
        b_ms, b_by = bound(moved, 0)
        rows[cell] = dict(ms=wrapper, kernel_ms=sum(alone) / 2,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          host_ms=sorted(host_ms)[1])
        log(f"phase 25b {cell}: {blen.numel()} blocks in {len(parts)} "
            f"scans, {sum(n // b for n, b in parts)} rows, {total} live "
            f"words, {out_bytes} bytes joined ({[len(x) for x in want]}); "
            f"one join launch; file == kernel == plain == native.join_blocks;"
            f" kernel alone {alone[0]:.4f}/{alone[1]:.4f} ms, wrapper "
            f"{wrapper:.4f} ms, plain {plain_ms:.3f} ms (CUDA events), host "
            f"join {', '.join(f'{t:.1f}' for t in host_ms)} ms (host "
            f"clock); bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB: "
            f"live words and lengths read, scans written once; "
            f"{100 * b_ms / (sum(alone) / 2):.1f}% of the kernel alone) | "
            f"{card}")
    log(f"phase 25: {time.perf_counter() - t25:.1f} s | {card}")
    return {"row": rows["libdefault_8k.encode_api0_c1"], "rows": rows,
            "path_launches": path_launches}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--previous-wire-kernel", type=pathlib.Path,
                    help="a copy of the parent commit's "
                         "libultrahdr_tpu_torch/csrc/wire_kernel.cu, made "
                         "outside the checkout: phase 18d times its two "
                         "kernels beside the current ones")
    ap.add_argument("--only-huffman", action="store_true",
                    help="phase 1's card line and phase 24 alone")
    ap.add_argument("--only-join", action="store_true",
                    help="phase 1's card line, the join kernel's build "
                         "(ptxas) and phase 25 alone")
    ap.add_argument("--huffman-split", nargs="+", type=pathlib.Path,
                    metavar="JPEG", help="print the entropy decode's "
                    "device ms a kernel for each JPEG as one JSON line "
                    "(phase 24b's child) and exit")
    args = ap.parse_args(argv)
    if args.huffman_split:
        print(json.dumps(huffman_split(args.huffman_split)), flush=True)
        return 0
    previous_wire_kernel = (args.previous_wire_kernel.resolve()
                            if args.previous_wire_kernel else None)
    import numpy as np
    import torch

    # ---- phase 1: the card ----------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    log(f"phase 1 card: torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        "name and power limit (nvidia-smi):")
    log(card)
    if args.only_huffman:
        p24 = huffman_phase(card)
        log(json.dumps({k: v for k, v in p24.items() if k != "rows"}))
        return 0
    if args.only_join:
        sys.path.insert(0, str(HERE))
        from libultrahdr_tpu_torch.jpeg import join_kernel
        join_kernel.JOIN_LIB.build()
        log(f"join kernel: {join_kernel.JOIN_LIB.build_seconds:.1f} s | "
            + " | ".join(ptxas_report(join_kernel.JOIN_LIB.build_log)))
        p25 = join_phase(card)
        log(json.dumps(p25["rows"]))
        return 0

    sys.path.insert(0, str(HERE))
    import libultrahdr_tpu_torch as port
    pkg_dir = pathlib.Path(port.__file__).resolve().parent
    if pkg_dir.parent != HERE:
        raise SystemExit(f"chip_smoke: imported the port from {pkg_dir}, "
                         f"not from this checkout ({HERE})")
    from libultrahdr_tpu_torch import fused, jpegr, testing
    from libultrahdr_tpu_torch.jpeg import dct, device_entropy, native
    from libultrahdr_tpu_torch.jpeg import huffman_kernel
    from libultrahdr_tpu_torch.jpeg import join_kernel
    from libultrahdr_tpu_torch.jpeg import decoder as jpeg_decoder
    from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
    from libultrahdr_tpu_torch.ops import apply as apply_ops
    from libultrahdr_tpu_torch.ops import apply_kernel as ak
    from libultrahdr_tpu_torch.ops import colors, gainmap, idw, pixel, tonemap
    from libultrahdr_tpu_torch.ops import stitch_kernel as stk
    from libultrahdr_tpu_torch.ops import wire_kernel as wk
    dev = torch.device("cuda", 0)
    CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt

    counted = {"pack_scan": pk.PACK_KERNEL, "pack_blocks": pk.PACK_BLOCKS_KERNEL,
               "pack_tiles": pk.PACK_TILES_KERNEL,
               "apply_gainmap": ak.APPLY_KERNEL,
               "forward_dct": dct.FORWARD_DCT_KERNEL,
               "wire_unslice": wk.UNSLICE_KERNEL,
               "down_pack": wk.DOWN_PACK_KERNEL,
               "stitch": stk.STITCH_KERNEL,
               "huffman": huffman_kernel.HUFFMAN_KERNEL,
               "join": join_kernel.JOIN_KERNEL}
    # every scan-kernel and join launch read on a path, for the records
    dct_launches, join_launches = [0], [0]
    # every scan the paths build (dct.scan_inputs, one kernel launch a
    # scan) and every plane of the general path's encoder (forward_plane),
    # with what the kernel gave the request, held against the plain
    # version on the same inputs when the path's counts are read
    built = []
    real_scan_inputs, real_forward_plane = dct.scan_inputs, dct.forward_plane

    def recording_scan_inputs(scans):
        out = real_scan_inputs(scans)
        built.append(("scans", scans, out))
        return out

    def recording_forward_plane(plane, q):
        out = real_forward_plane(plane, q)
        built.append(("plane", (plane, q), out))
        return out

    from libultrahdr_tpu_torch.jpeg import encoder as jpeg_encoder
    dct.scan_inputs = recording_scan_inputs
    jpeg_encoder.forward_plane = recording_forward_plane

    def check_built(path: str) -> str:
        """Hold every scan and plane built since the last check against the
        plain composition on the card (torch.equal); clears them."""
        torch.cuda.synchronize()
        n_scans = n_planes = 0
        for kind, args, out in built:
            if kind == "scans":
                want = dct.scan_inputs_plain(args)
                n_scans += len(args)
            else:
                want, out = (dct.forward_plane_plain(*args),), (out,)
                n_planes += 1
            tensors_equal(out, want, f"{path}: scan kernel")
        built.clear()
        return f"{n_scans} scans and {n_planes} planes"

    def zero_counts():
        for kern in counted.values():
            kern.launches = 0
        ak.APPLY_KERNEL.linear_launches = 0

    def read_counts(path: str, want: dict) -> dict:
        """The launch counts after driving `path`; raises unless they are
        `want` (kernels not named there: 0; the scan kernel, unless named,
        twice a pack launch: every fused encode packs its base and gain-map
        scans, built one launch each, in one launch; the join, unless
        named, once a pack launch: every fused encode joins both scans in
        one call, where the pipelined, K-batch and sharded encodes join on
        the host and name "join": 0).  "apply_linear"
        counts the apply kernel's LINEAR launches among its
        "apply_gainmap" ones.  Then every scan and plane the path built
        must equal its plain version."""
        got = {k: kern.launches for k, kern in counted.items()}
        got["apply_linear"] = ak.APPLY_KERNEL.linear_launches
        dct_launches[0] += got["forward_dct"]
        join_launches[0] += got["join"]
        expect = {k: want.get(k, 0) for k in got}
        if "forward_dct" not in want:
            expect["forward_dct"] = 2 * expect["pack_scan"]
        if "join" not in want:
            expect["join"] = expect["pack_scan"]
        if got != expect:
            raise AssertionError(f"{path}: kernel launches {got}, expected "
                                 f"{expect}")
        log(f"launches on the {path} path: {got}; scan kernel == plain "
            f"(torch.equal) on the {check_built(path)} it built")
        return got

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    libs = (("pack", pk.PACK_LIB), ("block pack", pk.BLOCK_PACK_LIB),
            ("apply", ak.APPLY_LIB), ("forward DCT", dct.DCT_LIB),
            ("wire", wk.WIRE_LIB), ("stitch", stk.STITCH_LIB),
            ("entropy decode", huffman_kernel.HUFFMAN_LIB),
            ("join", join_kernel.JOIN_LIB))
    from libultrahdr_tpu_torch.capi import build as capi_build

    def build_capi():
        """The C ABI shim linked against libpython and the two C programs
        on it (g++ / gcc)."""
        shim = capi_build.build_shim(linked=True)
        return shim, capi_build.build_program("test_capi", shim), \
            capi_build.build_program("capi_roundtrip", shim)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        capi_fut = pool.submit(build_capi)
        inproc_fut = pool.submit(capi_build.build_shim, linked=False)
        for f in [pool.submit(native.get_lib)] + [
                pool.submit(lib.build) for _, lib in libs]:
            f.result()
        capi_shim, capi_test_exe, capi_roundtrip_exe = capi_fut.result()
        capi_inproc_shim = inproc_fut.result()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s for the eight "
        "kernel libraries (nvcc sm_90a), the host C++ and the C ABI shim "
        "(two variants) with its C programs, in parallel")
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

    # the scan kernel on every edge layout: 4:2:0, 4:4:4, an RGB map
    # (4:4:4 from R, G, B) and 4:0:0; one block, one strip of 31 MCUs and
    # one more, phase 3's MCU grids above, sizes two short of whole MCUs
    # (the edge clamp), flat planes at both ends of the range at quality
    # 100 (every divisor 1) and 1, a column slice (not contiguous: the
    # wrapper copies it) and a row slice (a view at an offset); then two
    # scans back to back, and planes through forward_plane (raster order)
    from libultrahdr_tpu_torch.jpeg.tables import (STD_CHROMA_QUANT,
                                                   STD_LUMA_QUANT,
                                                   scaled_quant_table)
    rs = np.random.RandomState(3)
    noise = torch.from_numpy(rs.randint(0, 256, (3, 736, 1032)).astype(
        np.uint8)).to(dev)

    def edge_scan(kind, w_, h_, quality, fill=None, view=None):
        tables = [scaled_quant_table(t, quality) for t in (
            STD_LUMA_QUANT, STD_CHROMA_QUANT, STD_CHROMA_QUANT)]
        sub = {"420": [(h_, w_), (-(-h_ // 2), -(-w_ // 2))] + [
            (-(-h_ // 2), -(-w_ // 2))], "444": [(h_, w_)] * 3,
               "rgb": [(h_, w_)] * 3, "400": [(h_, w_)]}[kind]
        planes = []
        for i, (ph, pw) in enumerate(sub):
            if fill is not None:
                planes.append(torch.full((ph, pw), fill, dtype=torch.uint8,
                                         device=dev))
            elif view == "columns":
                planes.append(noise[i, :ph, 8:8 + pw])
            else:
                planes.append(noise[i, 8:8 + ph, :pw] if view == "rows"
                              else noise[i, :ph, :pw])
        sampling = {"420": fused._SAMPLING_420,
                    "400": fused._SAMPLING_400}.get(kind,
                                                    fused._SAMPLING_444)
        return fused._scan(planes, sampling, tables[:len(planes)],
                           rgb=kind == "rgb")

    before = dct.FORWARD_DCT_KERNEL.launches
    edge_cases = []
    for kind in ("420", "444", "rgb", "400"):
        step = 16 if kind == "420" else 8
        for what, w_, h_, quality, fill, view in (
                ("one MCU", step, step, 95, None, None),
                ("31 MCUs", 31 * step, step, 95, None, None),
                ("32 MCUs", 32 * step, 2 * step, 95, None, None),
                ("24x16 MCUs", 24 * step, 16 * step, 95, None, None),
                ("37x21 MCUs, 2 short", 37 * step - 2, 21 * step - 2, 90,
                 None, None),
                ("61x45 MCUs, 3 short", 61 * step - 3, 45 * step - 3, 60,
                 None, None),
                ("all 0", 3 * step, 2 * step, 100, 0, None),
                ("all 255", 3 * step, 2 * step, 1, 255, None),
                ("column slice", 5 * step - 1, 3 * step, 100, None,
                 "columns"),
                ("row slice", 9 * step, 4 * step + 3, 50, None, "rows")):
            edge_cases.append((f"{kind} {what}",
                               edge_scan(kind, w_, h_, quality, fill, view)))
    for what, scan in edge_cases:
        tensors_equal(dct.scan_inputs([scan]), dct.scan_inputs_plain([scan]),
                      f"scan kernel on {what}")
    pair = [edge_cases[3][1], edge_cases[23][1]]
    tensors_equal(dct.scan_inputs(pair), dct.scan_inputs_plain(pair),
                  "scan kernel on two scans back to back")
    for what, plane, quality in (
            ("one block", noise[0, :8, :8], 95),
            ("129 x 92 blocks", noise[0, :, :1032], 95),
            ("a column slice", noise[1, :64, 8:112], 80)):
        for table in (STD_LUMA_QUANT, STD_CHROMA_QUANT):
            q = scaled_quant_table(table, quality)
            tensors_equal((dct.forward_plane(plane, q),),
                          (dct.forward_plane_plain(plane, q),),
                          f"forward_plane on {what}")
    built.clear()
    launched = dct.FORWARD_DCT_KERNEL.launches - before
    if launched != len(edge_cases) + 2 + 6:
        raise AssertionError(f"phase 3 launched the scan kernel {launched} "
                             "times")
    log(f"phase 3 scan kernel == plain (torch.equal) on {len(edge_cases)} "
        "edge scans (4:2:0, 4:4:4, RGB and 4:0:0 x one MCU, 31 and 32 MCUs, "
        "24x16, 37x21 and 61x45 MCUs with ragged edges, flat 0 at quality "
        "100, flat 255 at quality 1, a column and a row slice), two scans "
        "back to back, and 3 planes x 2 tables through forward_plane")
    # ---- phase 4: the encode paths ---------------------------------------
    w, h = 3840, 2160
    configs = {"benchmark": dict(scale=4, multichannel=False),
               "default": dict(scale=1, multichannel=True)}

    def encode(img, kw, what: str, phase: str = "4") -> bytes:
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
        log(f"phase {phase} encode {what}: {ms:.1f} ms, "
            f"{w * h / ms / 1e3:.2f} MP/s, {len(data)} bytes | {card}")
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
        for jpeg, (src, layout) in zip((primary, gm_jpeg), scans):
            got = testing.decode_scan_coeffs(jpeg, layout)
            for g, c in zip(got, testing.scan_coeffs(src, layout)):
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
    # the scan kernel twice a request: the base and the gain-map scan
    p010_launches = read_counts("P010 encode", {"pack_scan": 6,
                                                "forward_dct": 12})

    kernel_rows, dct_rows, p010_scans, p010_jpegs = {}, {}, {}, {}
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        if any(d != data for d in outputs[cfg]):
            raise AssertionError(f"{cfg}: the three requests differ")
        primary, gm_jpeg, scans = check_encode(
            data, img, kw, fused._api0_p010_block_buffers, p010_planes,
            fused.encode_api0_p010_fused, f"P010 {cfg}",
            rng=port.ColorRange.FULL)
        p010_scans[cfg] = [(testing.scan_coeffs(src, lay), lay)
                           for src, lay in scans]
        p010_jpegs[cfg] = (primary, gm_jpeg)
        ins = dct.scan_inputs(scans)
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

        # the scan kernel on this request's two scans (those of
        # check_encode: the request's stages rerun): alone (both launches
        # into one set of inputs), through its dispatcher, and the plain
        # composition; and on the luma plane alone (forward_plane)
        def scan_launches():
            off = 0
            for src_, lay_ in scans:
                n_ = lay_.mcus_h * lay_.bpr
                dct.FORWARD_DCT_KERNEL.scan(src_, lay_, *(
                    t[off:off + n_] for t in ins))
                off += n_

        d_kernel = [testing.launch_ms(scan_launches) for _ in range(2)]
        d_ms = [cuda_ms(lambda: real_scan_inputs(scans), 20)
                for _ in range(2)]
        d_plain = [cuda_ms(lambda: dct.scan_inputs_plain(scans), 5)
                   for _ in range(2)]
        luma, q = scans[0][0].planes[0], scans[0][0].qtables[0]
        d_luma = [testing.launch_ms(lambda: dct.forward_plane(luma, q))
                  for _ in range(2)]
        built.clear()
        # bytes: the source planes read once, 136 bytes a block written;
        # operations: 1,920 multiplies and adds and 64 divisions a block,
        # and an RGB source's conversion, 10 a sample and component
        n_blocks = ins[0].shape[0]
        src_bytes = sum(nbytes(*src_.planes) for src_, _ in scans)
        ops = (1920 + 64) * n_blocks + sum(
            30 * lay_.mcus_h * lay_.bpr * 64 // 3
            for src_, lay_ in scans if src_.rgb)
        d_bound, d_by = bound(src_bytes + nbytes(*ins), ops)
        l_bound, _ = bound(nbytes(luma) + 128 * (luma.numel() // 64),
                           (1920 + 64) * (luma.numel() // 64))
        dct_rows[cfg] = dict(ms=sum(d_ms) / 2, kernel_ms=sum(d_kernel) / 2,
                             plain_ms=sum(d_plain) / 2, err=0,
                             bound_ms=d_bound, bound_by=d_by,
                             luma_ms=sum(d_luma) / 2, luma_bound_ms=l_bound)
        log(f"phase 4 scan kernel {cfg}: {n_blocks} blocks in 2 scans "
            f"({[lay_.sampling for _, lay_ in scans]}, RGB map "
            f"{scans[1][0].rgb}), kernel alone {d_kernel[0]:.4f}/"
            f"{d_kernel[1]:.4f} ms, dispatcher {d_ms[0]:.4f}/{d_ms[1]:.4f} "
            f"ms, plain {d_plain[0]:.3f}/{d_plain[1]:.3f} ms (CUDA events), "
            f"bound {d_bound:.4f} ms ({d_by}; {(src_bytes + nbytes(*ins)) / 1e6:.1f}"
            f" MB, {ops / 1e9:.3f} G float ops, at the float32 issue rate "
            f"{ops / 33.5e12 * 1e3:.4f} ms), {d_bound / (sum(d_kernel) / 2):.0%}"
            f" of it; the luma plane {tuple(luma.shape)} alone "
            f"{d_luma[0]:.4f}/{d_luma[1]:.4f} ms, bound {l_bound:.4f} ms "
            f"| {card}")
        del ins, luma

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
                               {"pack_scan": 2 * len(rgb_outputs),
                                "forward_dct": 4 * len(rgb_outputs)})
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

    # ---- phase 4c: the fused map's clipped gains -------------------------
    # The JAX package's fused programs compile encode_gain with constant
    # boosts, which XLA folds to log(gain) * c: a clipped HLG gain codes 254
    # there.  The port's fused map computes that form
    # (gainmap.encode_gain_folded); a clipped sample lands within an ulp of
    # a code boundary, so the card's log must give the CPU's codes.
    t4c = time.perf_counter()
    bits = {}
    for ct in (CT.HLG, CT.PQ):
        mb = colors.reference_display_peak_nits(ct) / 203.0
        bits[ct.name] = [f"{np.array(v, np.float32).view(np.uint32):08x}"
                         for v in (torch.log(torch.tensor(
                             mb, dtype=torch.float32, device=d)).item()
                                   for d in ("cpu", dev))]
    log("phase 4c float32 bits of log(max boost), CPU / card: " + ", ".join(
        f"{k} {a} / {b}" for k, (a, b) in bits.items()) + f" | {card}")

    def clipped_highlights(ct):
        """``testing.photo_p010`` with a band of bright, saturated patches
        whose gains clip in both configurations, labelled `ct`."""
        base = testing.photo_p010(w, h)
        y, uv = (np.array(p, np.uint16) for p in base.planes[:2])
        rows, x0, x1 = slice(h // 16, h // 8), w // 16, w * 15 // 16
        y[2 * rows.start:2 * rows.stop, x0:x1] = 1000 << 6
        cols = ((300, 800), (800, 300), (250, 250), (800, 800), (512, 512))
        step = (x1 - x0) // len(cols) // 2 * 2
        for i, (u, v) in enumerate(cols):
            c0 = x0 // 2 * 2 + i * step
            uv[rows, c0:c0 + step:2] = u << 6
            uv[rows, c0 + 1:c0 + step:2] = v << 6
        return port.RawImage(Fmt.P010, CG.BT2100, ct, port.ColorRange.FULL,
                             w, h, [y, uv])

    fold_imgs = {f"photo seed {s} HLG": testing.photo_p010(w, h, seed=s)
                 for s in (4, 6, 8)}
    for ct in (CT.HLG, CT.PQ):
        fold_imgs[f"clipped highlights {ct.name}"] = clipped_highlights(ct)
    zero_counts()
    for what, fimg in fold_imgs.items():
        for cfg, kw in configs.items():
            encode(fimg, kw, f"{what} {cfg}", phase="4c")
    fold_launches = read_counts("clipped-gain encode",
                                {"pack_scan": 2 * len(fold_imgs),
                                 "forward_dct": 4 * len(fold_imgs)})
    use_base_cg = fused._use_base_cg(CG.DISPLAY_P3, CG.BT2100,
                                     port.JpegR(device=dev).write_xmp)
    for what, fimg in fold_imgs.items():
        ct = CT(fimg.ct)
        mb = np.float32(colors.reference_display_peak_nits(ct) / 203.0)
        planes = [np.asarray(p, np.uint16) for p in fimg.planes[:2]]
        for cfg, kw in configs.items():
            stage = dict(cg=CG.BT2100, ct=ct, rng=port.ColorRange.FULL,
                         gamma=1.0, use_base_cg=use_base_cg, **kw)
            cpu_px = fused.api0_p010_pixels(
                *fused.upload_planes(planes, torch.device("cpu")), **stage)
            card_px = [t.cpu().numpy() for t in fused.api0_p010_pixels(
                *fused.upload_planes(planes, dev), **stage)]
            for a, b in zip(card_px[:3], cpu_px[:3]):
                close_u8(a, b.numpy(), f"4c {what} {cfg} SDR")
            # the map stage on each device from the CPU's SDR planes (one
            # u8 step of a dark SDR sample moves its gain by several steps)
            maps, clipped = {}, None
            for d in ("cpu", dev):
                hdr = pixel.unpack_p010(
                    *fused.upload_planes(planes, torch.device(d)),
                    port.ColorRange.FULL, h, w)
                sdr = pixel.unpack_yuv8(*(p.to(d) for p in cpu_px[:3]),
                                        2, 2, h, w)
                maps[d] = fused._onepass_gainmap(
                    sdr, hdr, sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010,
                    cg=CG.BT2100, ct=ct, scale=kw["scale"],
                    multichannel=kw["multichannel"], gamma=1.0,
                    use_base_cg=use_base_cg).cpu().numpy()
                if d == "cpu":
                    s_n, h_n = gainmap._nits_pair(gainmap._prep(
                        sdr, hdr, Fmt.YUV420, Fmt.P010, CG.DISPLAY_P3,
                        CG.BT2100, ct, kw["scale"], False, use_base_cg),
                        kw["multichannel"], False, CG.DISPLAY_P3)
                    clipped = (torch.where(
                        s_n > 0, h_n / torch.clamp(s_n, min=1e-37), 1.0)
                        >= mb).numpy()
            cpu_map, card_map = maps["cpu"], maps[dev]
            codes = np.unique(cpu_map[clipped]).tolist()
            want = [254] if ct == CT.HLG else [255]
            if not clipped.any() or codes != want:
                raise AssertionError(f"4c {what} {cfg}: {clipped.sum()} "
                                     f"clipped samples, codes {codes}")
            if not np.array_equal(card_map[clipped], cpu_map[clipped]):
                raise AssertionError(f"4c {what} {cfg}: the card's code of "
                                     "a clipped sample differs from the "
                                     "CPU's")
            close_u8(card_map, cpu_map, f"4c {what} {cfg} gain map")
            own = card_px[3] != cpu_map
            log(f"phase 4c {what} {cfg}: {int(clipped.sum())} of "
                f"{clipped.size} samples clipped, coded {codes} on the CPU "
                f"and the card; the rest {int((card_map != cpu_map).sum())}"
                f" samples apart; the card's map from its own SDR "
                f"{int(own.sum())} apart ({int(own[clipped].sum())} "
                "clipped)")
    log(f"phase 4c: {time.perf_counter() - t4c:.1f} s | {card}")

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
        for jpeg, (src, layout) in zip((primary, gm_jpeg), scans):
            for g, c in zip(testing.decode_scan_coeffs(jpeg, layout),
                            testing.scan_coeffs(src, layout)):
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
    # API-2 and API-3 compress the 3-channel map on the general path: one
    # forward_plane launch a plane
    compressed_launches = read_counts("API-2/3/4 encode",
                                      {"forward_dct": 6})
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
            planes, fmt = jpeg_decoder.decode_to_planes(sdr_jpeg, None,
                                                        device=dev)
            sdr_i = port.RawImage(fmt, CG.DISPLAY_P3, CT.SRGB,
                                  port.ColorRange.FULL, w, h, planes)
            on_cpu, _ = jpeg_decoder.decode_to_planes(
                sdr_jpeg, None, device=torch.device("cpu"))
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
    apply_launches = read_counts("decode", {"apply_gainmap": 6,
                                            "apply_linear": 2})

    apply_rows = {}
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        primary, pinfo, gm_jpeg, gm_info, md, sdr_cg, gm_cg = \
            port.JpegR(device="cuda")._parse_jpegr(data)
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
        # (as JpegR._decode_fused computes them)
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

    # ---- phase 7: the pipelined encode ------------------------------------
    # eight 4K images (photo_p010 at eight seeds) per configuration through
    # fused.encode_api0_p010_pipelined, twice: one pack launch an image, and
    # every file equal to the single-image encode of its image on the card
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        many = list(pool.map(lambda s: testing.photo_p010(w, h, seed=s),
                             range(8)))
    n_img = len(many)
    piped, pipe_launches = {}, 0
    for cfg, kw in configs.items():
        jr = port.JpegR(device="cuda", map_dimension_scale_factor=kw["scale"],
                        use_multi_channel_gainmap=kw["multichannel"])
        runs = []
        for run in range(2):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs_p = fused.encode_api0_p010_pipelined(jr, many, 95)
            runs.append((time.perf_counter() - t0) * 1e3)
            pipe_launches += read_counts(
                f"pipelined encode {cfg} run {run}",
                {"pack_scan": n_img, "join": 0})["pack_scan"]
            if run and outs_p != piped[cfg]:
                raise AssertionError(f"pipelined encode {cfg}: the two runs "
                                     "differ")
            piped[cfg] = outs_p
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles = [encode(im, kw, f"P010 {cfg} seed {i} (one at a time)",
                          "7") for i, im in enumerate(many)]
        loop_ms = (time.perf_counter() - t0) * 1e3
        bad = [i for i, (a, b) in enumerate(zip(piped[cfg], singles))
               if a != b]
        if bad:
            raise AssertionError(f"pipelined encode {cfg}: files {bad} != "
                                 "the single-image encodes")
        log(f"phase 7 pipelined encode {cfg}: {n_img} images in "
            f"{runs[0]:.1f} / {runs[1]:.1f} ms, "
            f"{n_img * w * h / runs[1] / 1e3:.2f} MP/s (second run), "
            f"against {loop_ms:.1f} ms, {n_img * w * h / loop_ms / 1e3:.2f} "
            f"MP/s one request at a time; every file == the single-image "
            f"encode on the card | {card}")

    # ---- phase 8: the batch decode ------------------------------------------
    # decode_to_device_batch over phase 7's eight files (the benchmark
    # configuration's to HLG, the default's to LINEAR): one apply launch a
    # stream, every output bit-identical to the per-image route on the card
    batch_launches, per_image = {}, {}
    for cfg, ct in (("benchmark", CT.HLG), ("default", CT.LINEAR)):
        jr = port.JpegR(device="cuda")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_b = jr.decode_to_device_batch(piped[cfg], ct)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        batch_launches[ct] = read_counts(
            f"batch decode {cfg} {ct.name}",
            {"apply_gainmap": n_img,
             "apply_linear": n_img if ct == CT.LINEAR else 0})
        t0 = time.perf_counter()
        per_image[cfg, ct] = [jr.decode_to_device(d, ct, microbatch=False)[0]
                              for d in piped[cfg]]
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        for i, ((got, _), want) in enumerate(zip(outs_b,
                                                 per_image[cfg, ct])):
            bit_identical(got, want, f"batch decode {cfg} {ct.name} "
                          f"stream {i} vs the per-image route")
        log(f"phase 8 batch decode {cfg} {ct.name}: {n_img} streams in "
            f"{batch_ms:.1f} ms ({batch_ms / n_img:.1f} ms, "
            f"{n_img * w * h / batch_ms / 1e3:.2f} MP/s an image), against "
            f"{one_ms:.1f} ms ({one_ms / n_img:.1f} ms, "
            f"{n_img * w * h / one_ms / 1e3:.2f} MP/s) one stream at a time; "
            f"every output bit-identical to the per-image route | {card}")

    # ---- phase 9: concurrent callers coalesced ----------------------------
    # four decode_to_device callers on four threads; the microbatcher (its
    # window long enough that the four meet, its batch four) dispatches one
    # batch of four from the leader's thread
    jr = port.JpegR(device="cuda")
    jr._mb = jpegr._DeviceDecodeMicrobatcher(window_s=2.0, max_k=4)
    callers = [None] * 4
    meet = threading.Barrier(4)

    def caller(i):
        meet.wait()
        callers[i] = jr.decode_to_device(piped["benchmark"][i], CT.HLG)

    zero_counts()
    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    mb_ms = (time.perf_counter() - t0) * 1e3
    mb_launches = read_counts("4 concurrent decode_to_device callers",
                              {"apply_gainmap": 4})
    if None in callers or (jr._mb.batches, jr._mb.retries) != (1, 0):
        raise AssertionError(f"concurrent callers: {jr._mb.batches} batch "
                             f"dispatches, {jr._mb.retries} retries, not one "
                             "batch and none")
    for i, (got, _) in enumerate(callers):
        bit_identical(got, per_image["benchmark", CT.HLG][i],
                      f"caller {i} vs the per-image route")
    log(f"phase 9 4 concurrent decode_to_device callers: one batch dispatch "
        f"of 4, no retry, {mb_ms:.1f} ms, every output bit-identical to the "
        f"per-image route | {card}")

    # ---- phase 10: SRGB output --------------------------------------------
    # one RGBA8888 / SRGB decode per configuration through UhdrDecoder on the
    # card (no kernel on this path), equal to the same decode on CPU tensors
    srgb = {}
    for cfg in configs:
        for d in ("cuda", "cpu"):
            if d == "cuda":
                zero_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec = port.UhdrDecoder(device=d)
            dec.set_image(outputs[cfg][0])
            dec.set_out_color_transfer(CT.SRGB)
            dec.set_out_img_format(Fmt.RGBA8888)
            srgb[d] = (dec.decode(), dec.get_decoded_gainmap_image())
            ms = (time.perf_counter() - t0) * 1e3
            if d == "cuda":
                read_counts(f"SRGB decode {cfg}", {})
                srgb_ms = ms
        (img_g, gm_g), (img_c, gm_c) = srgb["cuda"], srgb["cpu"]
        if not (np.array_equal(img_g.planes[0], img_c.planes[0])
                and np.array_equal(gm_g.planes[0], gm_c.planes[0])
                and img_g.planes[0].shape == (h, w)):
            raise AssertionError(f"SRGB decode {cfg}: card != CPU")
        log(f"phase 10 SRGB decode {cfg}: {srgb_ms:.1f} ms, "
            f"{w * h / srgb_ms / 1e3:.2f} MP/s, RGBA8888 {img_g.w}x{img_g.h} "
            f"and gain map {Fmt(gm_g.fmt).name} {gm_g.w}x{gm_g.h} == the "
            f"decode on CPU tensors, byte for byte | {card}")
        # the host SRGB engine (UHDR_TPU_DECODE_ENGINE=host), twice, beside
        # the card's: no launch, the JAX package's engine (the CPU tests
        # hold its bytes), within 2 codes of the card's islow decode
        host_ms = []
        os.environ["UHDR_TPU_DECODE_ENGINE"] = "host"
        try:
            for _ in range(2):
                zero_counts()
                t0 = time.perf_counter()
                dec = port.UhdrDecoder(device="cuda")
                dec.set_image(outputs[cfg][0])
                dec.set_out_color_transfer(CT.SRGB)
                dec.set_out_img_format(Fmt.RGBA8888)
                img_h = dec.decode()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                read_counts(f"SRGB decode {cfg}, host engine", {})
        finally:
            del os.environ["UHDR_TPU_DECODE_ENGINE"]
        primary_h, _, _ = testing.read_jpegr(outputs[cfg][0])
        if not np.array_equal(img_h.planes[0], jpeg_decoder.decode_to_rgba(
                primary_h, engine="host")):
            raise AssertionError(f"SRGB host engine {cfg}: != "
                                 "decode_to_rgba(engine='host')")
        gap = np.abs(img_h.planes[0].view(np.uint8).astype(np.int16)
                     - img_g.planes[0].view(np.uint8)).max()
        if gap > 2:
            raise AssertionError(f"SRGB host engine {cfg}: {gap} codes from "
                                 "the card's decode")
        log(f"phase 10 SRGB decode {cfg}, host engine: {host_ms[0]:.1f} / "
            f"{host_ms[1]:.1f} ms against the card's {srgb_ms:.1f}; at most "
            f"{gap} codes from it | {card}")

    # ---- phase 12: the general decode path --------------------------------
    # 4K streams that only the general path takes, each decoded through
    # UhdrDecoder(device="cuda") (or JpegR.decode(use_fused=False) for
    # phase 4's files): one apply launch a request (SRGB: none), its output
    # bit-identical to the plain apply on the card run on the request's own
    # stage outputs (JpegR._general_planes and _apply_inputs, the stages the
    # request ran)
    from libultrahdr_tpu_torch.container import icc as icc_mod
    from libultrahdr_tpu_torch.editor import resize_channels
    from libultrahdr_tpu_torch.jpeg.encoder import JpegEncoder
    b_primary, b_gm, b_md = testing.read_jpegr(outputs["benchmark"][0])
    icc_p3 = icc_mod.write_icc_profile(CT.SRGB, CG.DISPLAY_P3)

    def yuv400(plane) -> port.RawImage:
        return port.RawImage(Fmt.YUV400, CG.UNSPECIFIED, CT.UNSPECIFIED,
                             port.ColorRange.FULL, plane.shape[1],
                             plane.shape[0], [plane])

    def api4_file(base_jpeg: bytes, gm_jpeg: bytes, md) -> bytes:
        enc = port.UhdrEncoder(device="cuda")
        enc.set_compressed_image(port.CompressedImage(base_jpeg,
                                                      CG.DISPLAY_P3),
                                 port.ImgLabel.BASE)
        enc.set_gainmap_image(port.CompressedImage(gm_jpeg), md)
        return enc.encode()

    def general_files(b_primary, b_gm, b_md, dv, crop_rows):
        """(resized-map file, grayscale-base file) from a file's parts on
        device dv: its map cropped to `crop_rows` rows and re-compressed,
        and its base's luma re-compressed as a YUV400 base (the port's
        JpegEncoder), each wrapped through API-4."""
        gm_info = jpeg_decoder.parse_jpeg(b_gm)
        (gy,), _ = jpeg_decoder.decode_to_planes(b_gm, gm_info, device=dv)
        cropped = JpegEncoder(dv).compress(
            yuv400(gy[:crop_rows].contiguous()), 95, icc=gm_info.icc,
            gainmap_comment=True)
        (by, _, _), _ = jpeg_decoder.decode_to_planes(b_primary, None,
                                                      device=dv)
        gray = JpegEncoder(dv).compress(yuv400(by), 95, icc=icc_p3)
        return (api4_file(testing.without_app_segments(b_primary, True),
                          cropped, b_md),
                api4_file(gray, testing.without_app_segments(b_gm, True),
                          b_md))

    zero_counts()
    frac = {mc: encode(img, dict(scale=7, multichannel=mc),
                       f"P010 map scale 7 {3 if mc else 1}-channel", "12")
            for mc in (False, True)}
    resized, gray = general_files(b_primary, b_gm, b_md, dev, 480)
    # two fused encodes (2 scans each) and two YUV400 compressions on the
    # general path (one plane each)
    general_input_launches = read_counts("the general path's input encodes",
                                         {"pack_scan": 2, "forward_dct": 6})
    progressive = testing.PROGRESSIVE_FIXTURE.read_bytes()
    general = [  # (what, file, output, use_fused)
        ("fractional 1-channel", frac[False], CT.HLG, True),
        ("fractional 1-channel", frac[False], CT.LINEAR, True),
        ("fractional 3-channel", frac[True], CT.HLG, True),
        ("fractional 3-channel", frac[True], CT.LINEAR, True),
        ("resized map", resized, CT.PQ, True),
        ("grayscale base", gray, CT.HLG, True),
        ("progressive fixture", progressive, CT.HLG, True),
        ("progressive fixture", progressive, CT.SRGB, True),
        ("use_fused=False benchmark", outputs["benchmark"][0], CT.HLG, False),
        ("use_fused=False default", outputs["default"][0], CT.HLG, False)]
    jr_g = port.JpegR(device="cuda")
    general_out, general_ms = [], []
    zero_counts()
    for what, data, ct, use_fused in general:
        before = ak.APPLY_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if use_fused:
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(data)
            dec.set_out_color_transfer(ct)
            dec.set_out_img_format(fmt_of.get(ct, Fmt.RGBA8888))
            img_out = dec.decode()
        else:
            img_out, _, _ = jr_g.decode(data, ct, use_fused=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = 0 if ct == CT.SRGB else 1
        if ak.APPLY_KERNEL.launches != before + want:
            raise AssertionError(f"general path {what} {ct.name} launched "
                                 f"the apply kernel "
                                 f"{ak.APPLY_KERNEL.launches - before} "
                                 f"times, not {want}")
        general_out.append(img_out)
        general_ms.append(ms)
        log(f"phase 12 decode {what} {ct.name}: {ms:.1f} ms, "
            f"{w * h / ms / 1e3:.2f} MP/s, {img_out.w}x{img_out.h} "
            f"{Fmt(img_out.fmt).name} | {card}")
    n_hdr = sum(ct != CT.SRGB for _, _, ct, _ in general)
    n_linear = sum(ct == CT.LINEAR for _, _, ct, _ in general)
    general_launches = read_counts("general decode", {
        "apply_gainmap": n_hdr, "apply_linear": n_linear})

    # the host stages of each request, timed alone on the same file
    for (what, data, ct, _), ms in zip(general, general_ms):
        if ct == CT.SRGB:
            continue
        t0 = time.perf_counter()
        parts = jr_g._parse_jpegr(data)
        t1 = time.perf_counter()
        jpeg_decoder.decode_coefficients(parts.primary, parts.pinfo)
        jpeg_decoder.decode_coefficients(parts.gm_jpeg, parts.gm_info)
        t2 = time.perf_counter()
        resize_ms = 0.0
        gm_info = parts.gm_info
        if abs(w / h - gm_info.width / gm_info.height) / (w / h) > 0.01:
            sdr, gain_u8 = jr_g._general_planes(parts)
            host_map = gain_u8.cpu().numpy()
            t3 = time.perf_counter()
            resize_channels(host_map, w, h)
            resize_ms = (time.perf_counter() - t3) * 1e3
        parse_ms, huff_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        log(f"phase 12 stages {what} {ct.name}: parse {parse_ms:.1f} ms, "
            f"host Huffman (both images) {huff_ms:.1f} ms, host resize "
            f"{resize_ms:.1f} ms, the rest (uploads, device stages, "
            f"download) {ms - parse_ms - huff_ms - resize_ms:.1f} ms of "
            f"{ms:.1f} | {card}")

    # each HDR request against the plain apply on its own stage outputs;
    # the kernel's time on the new gain shapes
    general_rows = {}
    for (what, data, ct, _), img_out in zip(general, general_out):
        if ct == CT.SRGB:
            continue
        parts = jr_g._parse_jpegr(data)
        sdr, gain_u8 = jr_g._general_planes(parts)
        a = jr_g._apply_inputs(sdr, gain_u8, parts.gm_cg, parts.metadata,
                               jpegr.FLT_MAX)
        gain = idw.idw_upsample(apply_ops._gain_to_float(a["gain"]),
                                a["scale_k"], h, w).contiguous()
        rows = ak.meta_to_rows(a["meta"])
        kw_a = dict(out_ct=ct, sdr_cg=a["sdr_cg"], hdr_cg=a["hdr_cg"],
                    use_base_cg=a["use_base_cg"])
        p_out = ak.apply_gainmap_plain(a["sdr_yuv"], gain, rows, a["weight"],
                                       **kw_a)
        apply_err = max(apply_err, bit_identical(
            img_out.planes[0], p_out,
            f"general path {what} {ct.name} vs plain apply"))
        shape = (f"{gain.shape[0]}-channel {a['gain'].dtype} "
                 f"{tuple(a['gain'].shape[1:])} gain at scale "
                 f"{a['scale_k']}")
        if what.startswith("fractional") and ct == CT.HLG:
            mapped = gain_u8.to(torch.float32) / torch.full(
                (), 255.0, device=dev)
            idw_ms = cuda_ms(lambda: idw.idw_upsample_fractional(
                mapped, w / gain_u8.shape[2], h, w), 5)
            shape += (f" | float-factor IDW {idw_ms:.3f} ms from the "
                      f"{gain_u8.shape[2]}x{gain_u8.shape[1]} map (CUDA "
                      "events)")
        if (what, ct) in (("fractional 3-channel", CT.HLG),
                          ("resized map", CT.PQ)):
            k_out = ak.APPLY_KERNEL(a["sdr_yuv"], gain, rows, a["weight"],
                                    **kw_a)
            bit_identical(k_out, p_out, f"apply kernel on {what}")
            ker_ms = cuda_ms(lambda: ak.APPLY_KERNEL(
                a["sdr_yuv"], gain, rows, a["weight"], **kw_a), 20)
            plain_ms = cuda_ms(lambda: ak.apply_gainmap_plain(
                a["sdr_yuv"], gain, rows, a["weight"], **kw_a), 5)
            moved = nbytes(a["sdr_yuv"], gain, k_out)
            b_ms, b_by = bound(moved, 150 * w * h)
            general_rows[what, ct] = dict(ms=ker_ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=b_by)
            shape += (f" | apply kernel {ker_ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms (CUDA events), bound {b_ms:.4f} ms "
                      f"({b_by}, {moved / 1e6:.0f} MB)")
        log(f"phase 12 checks {what} {ct.name}: == plain apply on its stage "
            f"outputs, bit-identical; {shape} | {card}")

    # the progressive fixture's planes: its coefficients through
    # inverse_plane on the card == on CPU tensors
    p_primary, p_gm = port.JpegR.extract_primary_and_gainmap(progressive)
    p_info = jpeg_decoder.parse_jpeg(p_primary)
    coeffs, qts, _ = jpeg_decoder.decode_coefficients(p_primary, p_info)
    hmax = max(c.h for c in p_info.components)
    vmax = max(c.v for c in p_info.components)
    for i, (c, q, comp) in enumerate(zip(coeffs, qts, p_info.components)):
        ph, pw = -(-h * comp.v // vmax), -(-w * comp.h // hmax)
        on_card = dct.inverse_plane(torch.from_numpy(c).to(dev), q, ph,
                                    pw).cpu()
        if not torch.equal(on_card, dct.inverse_plane(torch.from_numpy(c), q,
                                                      ph, pw)):
            raise AssertionError(f"progressive plane {i}: IDCT on the card "
                                 "!= on the CPU")
    log(f"phase 12 progressive fixture: {len(p_info.scans)} scans, planes "
        f"{', '.join(f'{c.shape[1] * 8}x{c.shape[0] * 8}' for c in coeffs)}"
        " (MCU-padded) bit-identical on the card and the CPU")
    # against the port's CPU decode: the fixture at 4K (no PIL here to make
    # a small progressive file), the other kinds small
    card_out = next(o for (what, _, ct, _), o in zip(general, general_out)
                    if what == "progressive fixture" and ct == CT.HLG)
    cpu_out = port.JpegR(device="cpu").decode(progressive, CT.HLG)[0]
    err, share = testing.check_decoded_close(
        card_out.planes[0], cpu_out.planes[0], CT.HLG,
        "progressive fixture card vs CPU")
    log(f"phase 12 progressive fixture HLG: card decode vs CPU decode "
        f"within the contract, max abs difference {err}, {share:.2e} of "
        "samples differ")
    sw, sh = 136, 72
    small_img = testing.photo_p010(sw, sh)

    def small_file(scale, mc):
        enc = port.UhdrEncoder(device="cpu")
        enc.set_raw_image(small_img, port.ImgLabel.HDR)
        enc.set_gainmap_scale_factor(scale)
        enc.set_using_multi_channel_gainmap(mc)
        return enc.encode()

    s_primary, s_gm, s_md = testing.read_jpegr(small_file(4, False))
    s_resized, s_gray = general_files(s_primary, s_gm, s_md,
                                      torch.device("cpu"), 12)
    smalls = {"fractional 1-channel": (small_file(3, False), True),
              "fractional 3-channel": (small_file(3, True), True),
              "resized map": (s_resized, True),
              "grayscale base": (s_gray, True),
              "use_fused=False benchmark": (small_file(4, False), False),
              "use_fused=False default": (small_file(1, True), False)}
    for what, (data, use_fused) in smalls.items():
        for ct in (CT.HLG, CT.LINEAR):
            res = {d: port.JpegR(device=d).decode(
                data, ct, use_fused=use_fused)[0].planes[0]
                for d in ("cuda", "cpu")}
            err, share = testing.check_decoded_close(
                res["cuda"], res["cpu"], ct, f"small {what} {ct.name}")
        log(f"phase 12 small image {what} ({sw}x{sh}): card decode vs CPU "
            f"decode within the contract, HLG and LINEAR, max abs "
            f"difference {err}, {share:.2e} of samples differ")

    # ---- phase 13: the host decode engine ---------------------------------
    # JpegR.decode_host of phase 4's files at 4K, on the host beside the
    # card's decode of the same file and transfer (UhdrDecoder on the card,
    # one apply launch), held to the JAX package's host-vs-device gate:
    # >= 55 dB a channel
    from libultrahdr_tpu_torch.tools.benchmarks import channel_psnr

    host_launches = {"apply_gainmap": 0, "apply_linear": 0}
    for cfg in configs:
        data = outputs[cfg][0]
        for ct in (CT.HLG, CT.LINEAR):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(data)
            dec.set_out_color_transfer(ct)
            dec.set_out_img_format(fmt_of[ct])
            card_img = dec.decode()
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            host_ms = []
            for _ in range(2):
                t0 = time.perf_counter()
                host_img, _ = jr_g.decode_host(data, ct)
                host_ms.append((time.perf_counter() - t0) * 1e3)
            got = read_counts(f"card decode beside decode_host {cfg} "
                              f"{ct.name}", {"apply_gainmap": 1,
                                             "apply_linear": int(
                                                 ct == CT.LINEAR)})
            for k in host_launches:
                host_launches[k] += got[k]
            db = channel_psnr(host_img.planes[0], card_img.planes[0])
            if min(db) < 55.0:
                raise AssertionError(f"decode_host {cfg} {ct.name}: "
                                     f"{db} dB against the card's decode")
            log(f"phase 13 decode_host {cfg} {ct.name}: {host_ms[0]:.1f} / "
                f"{host_ms[1]:.1f} ms on the host, "
                f"{w * h / host_ms[1] / 1e3:.2f} MP/s, against the card's "
                f"decode {card_ms:.1f} ms; "
                f"{', '.join(f'{x:.2f}' for x in db)} dB a channel against "
                f"the card's output | {card}")
    # the host engine's stages on the benchmark file, HLG, each timed alone
    data = outputs["benchmark"][0]
    primary, pinfo, gm_jpeg, gm_info, md, _, _ = jr_g._parse_jpegr(data)
    t0 = time.perf_counter()
    (bc, bq, _), (gc, gq, _) = (jpeg_decoder.decode_coefficients(j, i) for
                                j, i in ((primary, pinfo),
                                         (gm_jpeg, gm_info)))
    t1 = time.perf_counter()
    y, u, v = (native.idct_plane(c, q) for c, q in zip(bc, bq))
    gm8 = native.idct_plane(gc[0], gq[0])[:gm_info.height, :gm_info.width]
    t2 = time.perf_counter()
    meta15 = np.concatenate([np.asarray(getattr(md, f), np.float32) for f in (
        "gamma", "min_content_boost", "max_content_boost", "offset_sdr",
        "offset_hdr")])
    native.apply_gainmap_host(y, u, v, 2, 2, w, h, gm8, w // gm_info.width,
                              meta15, 1.0, 1, None, True)
    t3 = time.perf_counter()
    march = subprocess.run(
        [os.environ.get("UHDR_TPU_CXX", "g++"), "-march=native", "-Q",
         "--help=target"], capture_output=True, text=True).stdout
    march = re.search(r"-march=\s+(\S+)", march)
    log(f"phase 13 decode_host stages, benchmark HLG: host Huffman (both "
        f"images) {(t1 - t0) * 1e3:.1f} ms, float IDCT (4 planes) "
        f"{(t2 - t1) * 1e3:.1f} ms, apply (IDW, gain, OETF, packing) "
        f"{(t3 - t2) * 1e3:.1f} ms, one thread; the host C++ built with "
        f"-march=native = {march.group(1) if march else 'unknown'}")
    # pinned through the decoder: UHDR_TPU_DECODE_ENGINE=host
    os.environ["UHDR_TPU_DECODE_ENGINE"] = "host"
    try:
        zero_counts()
        dec = port.UhdrDecoder(device="cuda")
        dec.set_image(outputs["benchmark"][0])
        dec.set_out_color_transfer(CT.HLG)
        dec.set_out_img_format(Fmt.RGBA1010102)
        via = dec.decode().planes[0]
        read_counts("UhdrDecoder with UHDR_TPU_DECODE_ENGINE=host", {})
    finally:
        del os.environ["UHDR_TPU_DECODE_ENGINE"]
    if not np.array_equal(via, jr_g.decode_host(outputs["benchmark"][0],
                                                CT.HLG)[0].planes[0]):
        raise AssertionError("UHDR_TPU_DECODE_ENGINE=host != decode_host")
    log("phase 13 UhdrDecoder(device=\"cuda\") with "
        "UHDR_TPU_DECODE_ENGINE=host: == JpegR.decode_host, no launch")

    # ---- phase 14: effects ------------------------------------------------
    # (a) UhdrDecoder(device="cuda") with an effect queue on phase 4's two
    # files: each HDR request one apply launch, its image and gain map equal
    # to the port's host editor run on the same decode without effects,
    # downloaded.  A 3-channel map's RGB888 image fails the editor's 2-D
    # resize in both packages (tests/test_torch_effects.py), so the resizes
    # run on the benchmark file's single-channel map only.
    from libultrahdr_tpu_torch import api as port_api
    from libultrahdr_tpu_torch import editor
    from libultrahdr_tpu_torch.ops import effects_device

    def effects_of(spec):
        kinds = {"mirror": lambda d: port_api.MirrorEffect(
                     port.MirrorDirection(d)),
                 "rotate": port_api.RotateEffect,
                 "crop": port_api.CropEffect, "resize": port_api.ResizeEffect}
        return [kinds[e[0]](*e[1:]) for e in spec]

    def add_effects(ctx, spec):
        for e in spec:
            getattr(ctx, "add_effect_" + e[0])(*e[1:])

    def edit(im, spec):
        """The port's host editor applied to a RawImage for a queue whose
        crops lie inside the image."""
        for e in spec:
            if e[0] == "mirror":
                im = editor.apply_mirror(im, port.MirrorDirection(e[1]))
            elif e[0] == "rotate":
                im = editor.apply_rotate(im, e[1])
            elif e[0] == "crop":
                im = editor.apply_crop(im, e[1], e[3], e[2] - e[1],
                                       e[4] - e[3])
            else:
                im = editor.apply_resize(im, e[1], e[2])
        return im

    def gainmap_spec(spec, dw, dh, gw, gh):
        """The gain map's queue for a display queue: crop and resize
        coordinates divided by the dimension ratio (a float) and truncated,
        as ultrahdr_api.cpp:275-415 scales them."""
        out = []
        for e in spec:
            rw, rh = dw / gw, dh / gh
            if e[0] == "crop":
                g = ("crop", int(e[1] / rw), int(e[2] / rw), int(e[3] / rh),
                     int(e[4] / rh))
                dw, dh, gw, gh = e[2] - e[1], e[4] - e[3], g[2] - g[1], \
                    g[4] - g[3]
            elif e[0] == "resize":
                g = ("resize", int(e[1] / rw), int(e[2] / rh))
                dw, dh, gw, gh = e[1], e[2], g[1], g[2]
            else:
                g = e
                if e[0] == "rotate" and e[1] in (90, 270):
                    dw, dh, gw, gh = dh, dw, gh, gw
            out.append(g)
        return out

    def decode_fx(data, ct, spec):
        dec = port.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_color_transfer(ct)
        dec.set_out_img_format(fmt_of[ct])
        add_effects(dec, spec)
        return dec.decode(), dec.get_decoded_gainmap_image()

    # crop coordinates off the scale-4 grid; a chain through a rotation
    crop_e = ("crop", w // 38 | 1, w * 25 // 32 | 1, h // 38 | 1,
              h * 15 // 16 | 1)
    chain_crop = ("crop", h // 20 | 1, h * 19 // 20, w // 12 | 1,
                  w * 11 // 12)
    fx_cases = {  # (file, output, queue)
        "mirror H": ("benchmark", CT.HLG, [("mirror", 1)]),
        "mirror V": ("benchmark", CT.HLG, [("mirror", 0)]),
        "rotate 90": ("benchmark", CT.HLG, [("rotate", 90)]),
        "rotate 180": ("benchmark", CT.HLG, [("rotate", 180)]),
        "rotate 270": ("benchmark", CT.HLG, [("rotate", 270)]),
        "crop": ("benchmark", CT.HLG, [crop_e]),
        "resize down": ("benchmark", CT.HLG, [("resize", w // 2, h // 2)]),
        "resize up (row and column 0)": (
            "benchmark", CT.HLG, [("resize", w + w // 24, h + h // 9)]),
        "chain": ("benchmark", CT.HLG, [("mirror", 1), ("rotate", 90),
                                        chain_crop, ("resize", h // 4,
                                                     w // 4)]),
        "chain LINEAR": ("benchmark", CT.LINEAR, [
            ("mirror", 1), ("rotate", 90), chain_crop,
            ("resize", h // 4, w // 4)]),
        "default mirror H": ("default", CT.HLG, [("mirror", 1)]),
        "default mirror V": ("default", CT.HLG, [("mirror", 0)]),
        "default rotate 90": ("default", CT.HLG, [("rotate", 90)]),
        "default rotate 180": ("default", CT.HLG, [("rotate", 180)]),
        "default rotate 270": ("default", CT.HLG, [("rotate", 270)]),
        "default crop": ("default", CT.HLG, [crop_e]),
        "default chain": ("default", CT.HLG, [("mirror", 0), ("rotate", 270),
                                              chain_crop]),
        "default chain LINEAR": ("default", CT.LINEAR, [
            ("mirror", 0), ("rotate", 270), chain_crop]),
    }
    zero_counts()
    plain_fx = {}
    for cfg in configs:
        for ct in (CT.HLG, CT.LINEAR):
            plain_fx[cfg, ct] = decode_fx(outputs[cfg][0], ct, [])
    fx_out = {}
    for what, (cfg, ct, spec) in fx_cases.items():
        before = ak.APPLY_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fx_out[what] = decode_fx(outputs[cfg][0], ct, spec)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if ak.APPLY_KERNEL.launches != before + 1:
            raise AssertionError(f"decoder effects {what} did not launch the "
                                 "apply kernel exactly once")
        out_i = fx_out[what][0]
        log(f"phase 14 decode with effects {what} ({cfg} {ct.name}): "
            f"{ms:.1f} ms, {w * h / ms / 1e3:.2f} MP/s, {out_i.w}x{out_i.h} "
            f"{Fmt(out_i.fmt).name} | {card}")
    n_fx = len(plain_fx) + len(fx_cases)
    n_fx_linear = 2 + sum(ct == CT.LINEAR for _, ct, _ in fx_cases.values())
    fx_dec_launches = read_counts("decoder effects", {
        "apply_gainmap": n_fx, "apply_linear": n_fx_linear})
    for what, (cfg, ct, spec) in fx_cases.items():
        base_i, base_gm = plain_fx[cfg, ct]
        want_i = edit(base_i, spec)
        want_gm = edit(base_gm, gainmap_spec(spec, base_i.w, base_i.h,
                                             base_gm.w, base_gm.h))
        got_i, got_gm = fx_out[what]
        for part, got_p, want_p in (("image", got_i, want_i),
                                    ("gain map", got_gm, want_gm)):
            if (got_p.w, got_p.h, got_p.fmt) != (want_p.w, want_p.h,
                                                  want_p.fmt) or \
                    not np.array_equal(got_p.planes[0], want_p.planes[0]):
                raise AssertionError(f"decoder effects {what}: {part} != the "
                                     "host editor on the plain decode")
    log(f"phase 14 checks: {len(fx_cases)} decodes with effects, image and "
        "gain map each == the port's host editor on the decode without "
        "effects, bit for bit")

    # (b) decode_to_device(effects=...) on the per-image route and through
    # the microbatcher (four callers, four queues): CUDA tensors owning
    # their storage, each equal to the host editor on the plain output
    def owns(t):
        return t.is_cuda and t.is_contiguous() and t.storage_offset() == 0 \
            and t.untyped_storage().nbytes() == t.numel() * t.element_size()

    jr_fx = port.JpegR(device="cuda")
    dev_cases = [("benchmark", CT.HLG, []), ("benchmark", CT.LINEAR, []),
                 ("benchmark", CT.HLG, fx_cases["chain"][2]),
                 ("benchmark", CT.LINEAR, [("rotate", 180),
                                           ("resize", w // 2, h // 2)]),
                 ("default", CT.HLG, [("mirror", 0), crop_e])]
    zero_counts()
    dev_out = []
    for cfg, ct, spec in dev_cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed, _ = jr_fx.decode_to_device(outputs[cfg][0], ct,
                                           effects=effects_of(spec),
                                           microbatch=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dev_out.append(packed)
        log(f"phase 14 decode_to_device per image {cfg} {ct.name}, "
            f"{len(spec)} effects: {ms:.1f} ms, {w * h / ms / 1e3:.2f} MP/s, "
            f"{tuple(packed.shape)} {packed.dtype} on {packed.device} | "
            f"{card}")
    mb_specs = [[("rotate", 90)], [("mirror", 1), crop_e],
                [("resize", w // 2, h // 2)], fx_cases["chain"][2]]
    jr_mb = port.JpegR(device="cuda")
    jr_mb._mb = jpegr._DeviceDecodeMicrobatcher(window_s=2.0, max_k=4)
    mb_out = [None] * 4
    meet_fx = threading.Barrier(4)

    def caller_fx(i):
        meet_fx.wait()
        mb_out[i] = jr_mb.decode_to_device(outputs["benchmark"][0], CT.HLG,
                                           effects=effects_of(mb_specs[i]))

    threads = [threading.Thread(target=caller_fx, args=(i,))
               for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    mb_fx_ms = (time.perf_counter() - t0) * 1e3
    fx_dev_launches = read_counts("decode_to_device with effects", {
        "apply_gainmap": len(dev_cases) + 4,
        "apply_linear": sum(ct == CT.LINEAR for _, ct, _ in dev_cases)})
    if None in mb_out or (jr_mb._mb.batches, jr_mb._mb.retries) != (1, 0):
        raise AssertionError(f"effects through the microbatcher: "
                             f"{jr_mb._mb.batches} batch dispatches, "
                             f"{jr_mb._mb.retries} retries")
    for (cfg, ct, spec), got in [*zip(dev_cases, dev_out), *(
            (("benchmark", CT.HLG, s), o[0]) for s, o in zip(mb_specs,
                                                             mb_out))]:
        if not owns(got):
            raise AssertionError(f"decode_to_device {cfg} {spec}: not a "
                                 "CUDA tensor owning its storage")
        want = edit(plain_fx[cfg, ct][0], spec).planes[0]
        if not np.array_equal(testing.host_packed(got), want):
            raise AssertionError(f"decode_to_device {cfg} {ct.name} {spec}: "
                                 "!= the host editor on the plain output")
    log(f"phase 14 4 concurrent decode_to_device callers with 4 effect "
        f"queues: one batch dispatch of 4, no retry, {mb_fx_ms:.1f} ms; "
        f"every device-resident output a CUDA tensor owning its storage, == "
        f"the host editor on the plain output | {card}")

    # the device effects alone on the 4K packed outputs (CUDA events);
    # bound: the bytes the effect must read and write over 3.35 TB/s
    for packed, ct in ((dev_out[0], CT.HLG), (dev_out[1], CT.LINEAR)):
        for what, fn in (
                ("mirror H", lambda: effects_device.mirror_packed(
                    packed, port.MirrorDirection.HORIZONTAL)),
                ("rotate 90", lambda: effects_device.rotate_packed(
                    packed, 90)),
                ("rotate 180", lambda: effects_device.rotate_packed(
                    packed, 180)),
                ("crop", lambda: effects_device.crop_packed(
                    packed, crop_e[1], crop_e[3], crop_e[2] - crop_e[1],
                    crop_e[4] - crop_e[3])),
                ("resize down", lambda: effects_device.resize_packed(
                    packed, w // 2, h // 2))):
            # each output pixel is one pixel of the input, read once
            moved = 2 * nbytes(fn())
            fx_ms = [cuda_ms(fn, 20) for _ in range(2)]
            b_ms, _ = bound(moved, 0)
            log(f"phase 14 device effect {what} {ct.name} on "
                f"{tuple(packed.shape)} {packed.dtype}: "
                f"{fx_ms[0]:.4f}/{fx_ms[1]:.4f} ms (CUDA events), bound "
                f"{b_ms:.4f} ms ({moved / 1e6:.1f} MB read and written), "
                f"{moved / fx_ms[1] / 1e6:.0f} GB/s | {card}")

    # (c) UhdrEncoder(device="cuda") with effects: a rotated 4K P010 (a
    # 2160x3840 file), a crop with a mirror, and one API-1 request; each one
    # pack launch, each file checked as in phase 4 against the intents
    # edited beforehand on the host
    enc_crop = ("crop", w // 60 & ~1, w * 17 // 20 & ~1, h // 54 & ~1,
                h * 25 // 27 & ~1)
    enc_cases = {  # (configuration, queue, with the SDR intent)
        "P010 rotate 90": ("benchmark", [("rotate", 90)], False),
        "P010 crop + mirror": ("default", [enc_crop, ("mirror", 1)], False),
        "API-1 P010+YUV420 rotate 270 + crop REALTIME": (
            "benchmark", [("rotate", 270), ("crop", h // 54 & ~1,
                                            h * 25 // 27 & ~1, 0, w)], True)}
    zero_counts()
    enc_fx = {}
    for what, (cfg, spec, with_sdr) in enc_cases.items():
        kw = configs[cfg]
        before = pk.PACK_KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = port.UhdrEncoder(device="cuda")
        enc.set_raw_image(img, port.ImgLabel.HDR)
        if with_sdr:
            enc.set_raw_image(sdr_img, port.ImgLabel.SDR)
            enc.set_preset(port.EncPreset.REALTIME)
        enc.set_quality(95, port.ImgLabel.BASE)
        enc.set_gainmap_scale_factor(kw["scale"])
        enc.set_using_multi_channel_gainmap(kw["multichannel"])
        add_effects(enc, spec)
        enc_fx[what] = enc.encode()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if pk.PACK_KERNEL.launches != before + 1:
            raise AssertionError(f"{what} did not launch the pack kernel "
                                 "exactly once")
        log(f"phase 14 encode with effects {what} ({cfg}): {ms:.1f} ms, "
            f"{w * h / ms / 1e3:.2f} MP/s, {len(enc_fx[what])} bytes | "
            f"{card}")
    fx_enc_launches = read_counts("encoder effects",
                                  {"pack_scan": len(enc_cases)})
    for what, (cfg, spec, with_sdr) in enc_cases.items():
        edited = edit(img, spec)
        info = jr_fx.get_info(enc_fx[what])
        if (info["width"], info["height"]) != (edited.w, edited.h):
            raise AssertionError(f"{what}: a {info['width']}x"
                                 f"{info['height']} file, not "
                                 f"{edited.w}x{edited.h}")
        if with_sdr:
            check_api1(enc_fx[what], edited, edit(sdr_img, spec),
                       configs[cfg], port.EncPreset.REALTIME, what)
        else:
            check_encode(enc_fx[what], edited, configs[cfg],
                         fused._api0_p010_block_buffers,
                         [np.asarray(p, np.uint16)
                          for p in edited.planes[:2]],
                         fused.encode_api0_p010_fused, what,
                         rng=port.ColorRange.FULL)

    # ---- phase 15: AGTM ----------------------------------------------------
    # generate_gainmap_agtm (SMPTE 2094-50, two rules) of the 4K P010 and its
    # RGBA1010102 twin on the card against the port on the CPU (the u8
    # contract), the P010 map compressed on the card and wrapped with the
    # tone-mapped base through API-4, and that file decoded to HLG: one
    # apply launch (a scale-1 3-channel map), bit-identical to the plain
    # apply on the card run on the decode's own stage outputs
    from libultrahdr_tpu_torch import agtm
    agtm_md = agtm.DynamicMetadata(0.0, [
        agtm.GainCurveRule(1.0, agtm.ComponentMix(component=1.0),
                           [(0.0, 0.0), (1.0, 1.0)]),
        agtm.GainCurveRule(3.0, agtm.ComponentMix(rgb=(0.25, 0.4, 0.1),
                                                  max=0.3, min=0.2),
                           [(0.0, 0.0), (0.5, 2.5), (1.0, 3.0)])])
    agtm_maps = {}
    for what, src in (("P010", img), ("RGBA1010102", rgb_hdr)):
        zero_counts()
        agtm_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gm_a, md_a = agtm.generate_gainmap_agtm(src, agtm_md)
            torch.cuda.synchronize()
            agtm_ms.append((time.perf_counter() - t0) * 1e3)
        read_counts(f"AGTM {what}", {})
        gm_cpu, md_cpu = agtm.generate_gainmap_agtm(src, agtm_md,
                                                    device="cpu")
        close_u8(gm_a.planes[0], gm_cpu.planes[0], f"AGTM {what}")
        if md_a.hdr_capacity_max != md_cpu.hdr_capacity_max or \
                gm_a.planes[0].shape != (h, w, 3):
            raise AssertionError(f"AGTM {what}: metadata or shape differ")
        agtm_maps[what] = (gm_a, md_a)
        log(f"phase 15 AGTM {what}: {agtm_ms[0]:.1f} / {agtm_ms[1]:.1f} ms "
            f"on the card ({w * h / agtm_ms[1] / 1e3:.2f} MP/s), RGB888 map "
            f"within 1 LSB on <= 1e-3 of the samples of the CPU port's, "
            f"capacity {md_a.hdr_capacity_max:g} | {card}")
    jr_a = port.JpegR(device="cuda")
    gm_a, md_a = agtm_maps["P010"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agtm_gm_jpeg = jr_a.compress_gainmap(gm_a)
    agtm_base = JpegEncoder(dev).compress(jr_a.tone_map(img), 95,
                                          icc=icc_p3)
    enc = port.UhdrEncoder(device="cuda")
    enc.set_compressed_image(port.CompressedImage(agtm_base, CG.DISPLAY_P3),
                             port.ImgLabel.BASE)
    enc.set_gainmap_image(port.CompressedImage(agtm_gm_jpeg), md_a)
    agtm_file = enc.encode()
    torch.cuda.synchronize()
    wrap_ms = (time.perf_counter() - t0) * 1e3
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agtm_dec, _ = decode_fx(agtm_file, CT.HLG, [])
    torch.cuda.synchronize()
    agtm_dec_ms = (time.perf_counter() - t0) * 1e3
    # the general path's JPEG encoder writes no DRI: both scans of the
    # file are entropy-decoded on the card
    agtm_launches = read_counts("AGTM file decode", {"apply_gainmap": 1,
                                                     "huffman": 2})
    parts = jr_a._parse_jpegr(agtm_file)
    primary, pinfo, gm_jpeg, gm_info, md = parts[:5]
    plan = jpegr._plan_of(parts)
    if plan is None or (plan["scale_k"], plan["gm_channels"]) != (1, 3):
        raise AssertionError(f"AGTM file: not a fused scale-1 3-channel "
                             f"decode ({plan})")
    base = fused.decode_coefficients(primary, pinfo)
    gmap = fused.decode_coefficients(gm_jpeg, gm_info)
    sdr_yuv, gm_u8 = fused._decode_sdr_and_gain(
        fused.upload_coeff_planes(base[0], dev), base[1],
        fused.upload_coeff_planes(gmap[0], dev), gmap[1], h=h, w=w,
        sampling_key=plan["sampling_key"], gm_channels=3, scale_k=1)
    p_out = ak.apply_gainmap_plain(
        sdr_yuv, apply_ops._gain_to_float(gm_u8).contiguous(),
        ak.meta_to_rows(apply_ops.metadata_to_arrays(md)),
        np.float32(apply_ops.gainmap_weight(
            jpegr.FLT_MAX, float(md.hdr_capacity_min),
            float(md.hdr_capacity_max))), out_ct=CT.HLG,
        sdr_cg=plan["sdr_cg"], hdr_cg=plan["hdr_cg"],
        use_base_cg=plan["use_base_cg"])
    apply_err = max(apply_err, bit_identical(
        agtm_dec.planes[0], p_out, "AGTM file decode vs plain apply"))
    log(f"phase 15 AGTM JPEG_R: map compressed, base tone-mapped and "
        f"compressed, API-4 wrap {wrap_ms:.1f} ms ({len(agtm_file)} bytes); "
        f"HLG decode {agtm_dec_ms:.1f} ms, one apply launch on a "
        f"{gm_info.width}x{gm_info.height} 3-channel map, == plain apply on "
        f"its stage outputs, bit-identical | {card}")

    # ---- phase 16: the public API modules ---------------------------------
    # JpegRCompat (the legacy API, Android knobs), cli.main (the
    # ultrahdr_app analog, through a temporary directory) and capi_bridge
    # (from ctypes addresses of the 4K planes), all on their default device,
    # the card: each encode one pack launch, each decode one apply launch,
    # each result equal to the direct API call on the card
    import tempfile
    from libultrahdr_tpu_torch import capi_bridge, cli, jpegr_compat
    y_p, uv_p = (np.ascontiguousarray(p, np.uint16) for p in img.planes[:2])
    legacy = jpegr_compat.JpegRUncompressed(
        data=np.concatenate([y_p.reshape(-1), uv_p.reshape(-1)]), width=w,
        height=h, color_gamut=jpegr_compat.UltrahdrColorGamut.BT2100,
        color_range=port.ColorRange(img.range))
    legacy_dest = jpegr_compat.JpegRCompressed(data=bytearray(1 << 26),
                                               max_length=1 << 26)
    public_ms = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        public_ms[what] = (time.perf_counter() - t0) * 1e3
        log(f"phase 16 {what}: {public_ms[what]:.1f} ms, "
            f"{w * h / public_ms[what] / 1e3:.2f} MP/s | {card}")
        return out

    tmp = tempfile.TemporaryDirectory()
    tmpd = pathlib.Path(tmp.name)
    (tmpd / "in.p010").write_bytes(y_p.tobytes() + uv_p.tobytes())
    cli_enc = ["-m", "0", "-p", str(tmpd / "in.p010"), "-w", str(w), "-h",
               str(h), "-a", "0", "-C", "2", "-t", "1", "-R", "1", "-s", "4",
               "-M", "0", "-z", str(tmpd / "cli.jpg")]
    zero_counts()
    st = timed("JpegRCompat encode_api0", lambda: jpegr_compat.JpegRCompat(
        ).encode_api0(legacy, jpegr_compat.UltrahdrTransferFunction.HLG,
                      legacy_dest))
    if st != jpegr_compat.Status.JPEGR_NO_ERROR:
        raise AssertionError(f"JpegRCompat encode_api0: status {st}")
    legacy_blob = bytes(legacy_dest.data[:legacy_dest.length])
    legacy_out = jpegr_compat.JpegRUncompressed(
        data=np.zeros(w * h, np.uint32))
    st = timed("JpegRCompat decode_jpegr HDR_HLG",
               lambda: jpegr_compat.JpegRCompat().decode_jpegr(
                   jpegr_compat.JpegRCompressed(
                       data=bytearray(legacy_blob), length=len(legacy_blob)),
                   legacy_out,
                   output_format=jpegr_compat.UltrahdrOutputFormat.HDR_HLG))
    if st != jpegr_compat.Status.JPEGR_NO_ERROR:
        raise AssertionError(f"JpegRCompat decode_jpegr: status {st}")
    if timed("cli encode (-m 0)", lambda: cli.main(cli_enc)) != 0 or timed(
            "cli decode (-m 1)", lambda: cli.main([
                "-m", "1", "-j", str(tmpd / "cli.jpg"), "-o", "1", "-O", "5",
                "-z", str(tmpd / "cli.raw")])) != 0:
        raise AssertionError("cli.main failed")

    def bridge_encode():
        enc_b = capi_bridge.enc_new()
        capi_bridge.enc_set_raw_image(
            enc_b, int(Fmt.P010), int(CG.BT2100), int(CT.HLG),
            int(img.range), w, h, [y_p.ctypes.data, uv_p.ctypes.data],
            [w, w], int(port.ImgLabel.HDR))
        enc_b.set_gainmap_scale_factor(4)
        enc_b.set_using_multi_channel_gainmap(False)
        enc_b.encode()
        return capi_bridge.enc_get_stream(enc_b)

    bridge_file = timed("capi_bridge encode", bridge_encode)
    public_launches = read_counts("compat, CLI and bridge", {
        "pack_scan": 3, "apply_gainmap": 2})
    # the direct API calls on the card
    direct = port.JpegR(device="cuda", map_dimension_scale_factor=4,
                        map_compress_quality=85,
                        use_multi_channel_gainmap=False,
                        preset=port.EncPreset.REALTIME).encode_api0(img, 95)
    if legacy_blob != direct:
        raise AssertionError("JpegRCompat encode_api0 != JpegR.encode_api0")
    direct_dec = port.JpegR(device="cuda").decode(legacy_blob, CT.HLG)[0]
    if not np.array_equal(legacy_out.data.reshape(h, w),
                          direct_dec.planes[0]):
        raise AssertionError("JpegRCompat decode_jpegr != JpegR.decode")
    enc = port.UhdrEncoder(device="cuda")
    enc.set_raw_image(img, port.ImgLabel.HDR)
    enc.set_gainmap_scale_factor(4)
    enc.set_using_multi_channel_gainmap(False)
    cli_file = (tmpd / "cli.jpg").read_bytes()
    if cli_file != enc.encode() or bridge_file != outputs["benchmark"][0]:
        raise AssertionError("cli or capi_bridge encode != UhdrEncoder")
    dec = port.UhdrDecoder(device="cuda")
    dec.set_image(cli_file)
    dec.set_out_color_transfer(CT.HLG)
    dec.set_out_img_format(Fmt.RGBA1010102)
    if (tmpd / "cli.raw").read_bytes() != dec.decode().planes[0].tobytes():
        raise AssertionError("cli decode != UhdrDecoder")
    tmp.cleanup()
    log(f"phase 16 checks: JpegRCompat encode == JpegR.encode_api0 (Android "
        f"knobs), its HLG decode == JpegR.decode; cli encode and decode == "
        f"UhdrEncoder / UhdrDecoder; capi_bridge encode from ctypes "
        f"addresses == UhdrEncoder, all on the card | {card}")

    # ---- phase 17: batch and multi-GPU (parallel) ------------------------
    # every step over a mesh that repeats the card (its shards on four side
    # streams of it), held against the single-device route on the card;
    # over distinct cards too where the machine has more than one
    from libultrahdr_tpu_torch import parallel
    from libultrahdr_tpu_torch.parallel import batch as pbatch
    n_gpu = torch.cuda.device_count()
    mesh_sets = {"repeated": [dev] * 4}
    if n_gpu > 1:
        mesh_sets["distinct"] = [torch.device("cuda", i % n_gpu)
                                 for i in range(4)]
    else:
        log("phase 17: one GPU on this machine, so every mesh repeats it; "
            "copies between distinct cards are not exercised")
    w8, h8 = 8192, 4608
    img8 = testing.photo_p010(w8, h8)
    y8k = np.asarray(img8.planes[0], np.uint16)[None]
    uv8k = np.asarray(img8.planes[1], np.uint16)[None]

    def host_ms(fn):
        """(fn(), host ms) with the card synchronised before and after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the forward DCT kernel (jpeg/dct.py) gives a row shard's blocks the
    # whole plane's coefficients, those of its plain version; the batched
    # matrix product the port used before did not
    from libultrahdr_tpu_torch.jpeg.tables import (STD_LUMA_QUANT,
                                                   scaled_quant_table)
    q95 = scaled_quant_table(STD_LUMA_QUANT, 95)
    d_mat = torch.from_numpy(dct.dct_matrix()).to(dev)
    q_mat = torch.tensor(np.asarray(q95, np.float32).reshape(8, 8),
                         device=dev)

    def matmul_dct(p):
        blocks = (p.to(torch.float32) - 128.0).reshape(
            p.shape[0] // 8, 8, p.shape[1] // 8, 8).permute(0, 2, 1, 3)
        return torch.round(torch.matmul(torch.matmul(d_mat, blocks), d_mat.T)
                           / q_mat).to(torch.int16)

    luma = parallel.encode_core_p010(y8k[0], uv8k[0], device=dev)[0]
    moved = {}
    for dct_name, fn in (("forward_plane",
                          lambda p: dct.forward_plane(p, q95)),
                         ("batched matmul", matmul_dct)):
        whole = fn(luma).reshape(-1)
        parts = torch.cat([fn(p).reshape(-1) for p in luma.split(h8 // 4)])
        moved[dct_name] = int((whole != parts).sum())
    if moved["forward_plane"]:
        raise AssertionError(f"forward DCT: {moved['forward_plane']} "
                             "coefficients of a row shard differ")
    if not torch.equal(dct.forward_plane(luma, q95),
                       dct.forward_plane_plain(luma, q95)):
        raise AssertionError(f"forward DCT kernel != plain at {w8}x{h8}")
    log(f"phase 17 forward DCT of the {w8}x{h8} luma plane, whole against 4 "
        f"row shards: coefficients that moved {moved}; the kernel == plain "
        f"(torch.equal); ms "
        f"{cuda_ms(lambda: dct.forward_plane(luma, q95), 20):.4f} (kernel) "
        f"against {cuda_ms(lambda: dct.forward_plane_plain(luma, q95), 5):.3f}"
        f" (plain, elementwise) and {cuda_ms(lambda: matmul_dct(luma), 20):.3f}"
        f" (batched matmul, quantised, not zigzagged), CUDA events | {card}")
    del luma, whole, parts

    sharded_pack_launches = sharded_apply_launches = 0
    sharded_linear_launches = 0
    for mesh_name, devs in mesh_sets.items():
        m14 = parallel.make_mesh(1, 4, devs)
        # 17a: the sharded JPEG encode at 8K, both configurations
        for cfg, kw in configs.items():
            jr = port.JpegR(device="cuda",
                            map_dimension_scale_factor=kw["scale"],
                            use_multi_channel_gainmap=kw["multichannel"])
            step = pbatch.sharded_encode_jpeg_step(
                m14, scale=kw["scale"], multichannel=kw["multichannel"])
            step(y8k, uv8k)                                   # warm-up
            zero_counts()
            outs, step_ms = host_ms(lambda: step(y8k, uv8k))
            # per shard: its base and gain-map scans, one pack
            sharded_pack_launches += read_counts(
                f"sharded JPEG encode {cfg} ({mesh_name} mesh)",
                {"pack_scan": 4, "join": 0})["pack_scan"]
            # each shard's pack launch against the plain pack on the same
            # stream inputs (the shard's rows through the same stages)
            for s in range(4):
                rows, half = h8 // 4, h8 // 8
                scans = fused._api0_p010_block_buffers(
                    pixel.plane_tensor(y8k[0, s * rows:(s + 1) * rows], dev),
                    pixel.plane_tensor(uv8k[0, s * half:(s + 1) * half],
                                       dev),
                    cg=CG.BT2100, ct=CT.HLG, rng=port.ColorRange.FULL,
                    scale=kw["scale"], multichannel=kw["multichannel"],
                    gamma=1.0, quality=95, map_quality=95, use_base_cg=False)
                pw, pb = fused._pack_scans(scans, pk.pack_scan_plain)
                n_base = scans[0][1].mcus_h * scans[0][1].bpr
                tb = device_entropy.total_words(pb[:n_base].cpu().numpy())
                got_s = [o.shards[0][s][0] for o in outs]
                if not (torch.equal(got_s[1], pb[:n_base])
                        and torch.equal(got_s[3], pb[n_base:])
                        and torch.equal(got_s[0][:tb], pw[:tb])
                        and torch.equal(got_s[2][:pw.numel() - tb],
                                        pw[tb:])):
                    raise AssertionError(f"sharded JPEG encode {cfg}: shard "
                                         f"{s}'s pack != the plain pack")
            log(f"phase 17a sharded JPEG encode {cfg}: each shard's pack "
                f"launch ({pb.numel()} blocks, {pw.numel()} words in the "
                "last) == the plain pack on the same inputs (torch.equal)")
            del scans, pw, pb, got_s

            def single_scans():
                scans = fused._api0_p010_block_buffers(
                    *fused.upload_p010(img8, dev), cg=CG.BT2100, ct=CT.HLG,
                    rng=port.ColorRange.FULL, scale=kw["scale"],
                    multichannel=kw["multichannel"], gamma=1.0, quality=95,
                    map_quality=95, use_base_cg=False)
                words, blen = fused._pack_scans(scans, pk.pack_scan)
                return fused._join_scans(
                    words.cpu().numpy().view(np.uint32), blen.cpu().numpy(),
                    [lay for _, lay in scans]), [lay for _, lay in scans]

            single_scans()
            ((base_ref, gm_ref), (bl, gl)), single_ms = host_ms(single_scans)
            (base_s, gm_s), join_ms = host_ms(lambda: [
                pbatch.assemble_sharded_scan(
                    ws.gather()[0], ls.gather()[0].reshape(4, -1), lay.bpr)
                for ws, ls, lay in ((outs[0], outs[1], bl),
                                    (outs[2], outs[3], gl))])
            if base_s != base_ref:
                raise AssertionError(f"sharded JPEG encode {cfg}: base scan "
                                     "!= the single-device scan")
            what = "base scan"
            if kw["scale"] == 1:
                md = fused._onepass_metadata(jr, CT.HLG, use_base_cg=False)
                args = (jr, w8, h8, 95, base_s, fused._SAMPLING_420,
                        CG.DISPLAY_P3, 1, gm_s, md, None, CT.HLG, CG.BT2100)
                container = fused._assemble_container(*args)
                if gm_s != gm_ref or container != fused._assemble_container(
                        *args[:4], base_ref, *args[5:8], gm_ref, *args[9:]):
                    raise AssertionError(f"sharded JPEG encode {cfg}: gain-"
                                         "map scan or file != single-device")
                dec_img = jr.decode(container, CT.HLG)[0]
                if (dec_img.w, dec_img.h) != (w8, h8):
                    raise AssertionError("sharded 8K file: decode size")
                what = "base and gain-map scans and the file (decoded by " \
                    "JpegR.decode)"
            log(f"phase 17a sharded JPEG encode {cfg} {w8}x{h8}, mesh (1, 4)"
                f" {mesh_name}: step {step_ms:.1f} ms + gather and join "
                f"{join_ms:.1f} ms, against {single_ms:.1f} ms single-device "
                f"(block buffers, one pack, download, join); {what} == the "
                f"single-device ones byte for byte | {card}")

        # 17b: the sharded pixel encode, one-pass and two-pass
        two4k = [testing.photo_p010(w, h, seed=s) for s in (11, 12)]
        y4k = np.stack([np.asarray(im.planes[0], np.uint16) for im in two4k])
        uv4k = np.stack([np.asarray(im.planes[1], np.uint16) for im in two4k])
        for mesh_shape, ys, uvs in (((2, 2), y4k, uv4k), ((1, 4), y8k, uv8k)):
            mesh = parallel.make_mesh(*mesh_shape, devs)
            for two_pass in (False, True):
                step = parallel.sharded_encode_step(mesh, two_pass=two_pass)
                core = parallel.encode_core_p010_twopass if two_pass \
                    else parallel.encode_core_p010
                step(ys, uvs)
                zero_counts()
                outs, step_ms = host_ms(lambda: step(ys, uvs))
                read_counts(f"sharded encode {mesh_shape} two_pass "
                            f"{two_pass}", {})
                refs, single_ms = host_ms(lambda: [
                    core(ys[i], uvs[i], multichannel=True, device=dev)
                    for i in range(ys.shape[0])])
                got = [o.gather(dev) for o in outs]
                for i, ref in enumerate(refs):
                    for k, (g, r) in enumerate(zip(got, ref)):
                        g = g[i]
                        if k >= 4:
                            if not torch.allclose(g, r, rtol=1e-6, atol=0):
                                raise AssertionError(
                                    f"sharded two-pass bounds {mesh_shape}: "
                                    f"{g.tolist()} vs {r.tolist()}")
                        elif k == 3 and two_pass:
                            if (g.int() - r.int()).abs().max() > 1:
                                raise AssertionError(
                                    f"sharded two-pass map {mesh_shape}: "
                                    "differs by more than 1")
                        elif not torch.equal(g, r):
                            raise AssertionError(
                                f"sharded encode {mesh_shape} two_pass "
                                f"{two_pass}: output {k} of image {i} != "
                                "the single-device step")
                log(f"phase 17b sharded encode {'two' if two_pass else 'one'}"
                    f"-pass, {ys.shape[0]} x {ys.shape[2]}x{ys.shape[1]}, "
                    f"mesh {mesh_shape} {mesh_name}: {step_ms:.1f} ms against "
                    f"{single_ms:.1f} ms one image at a time on one device; "
                    + ("map within 1, bounds within 1e-6 relative, planes "
                       "bit-identical" if two_pass else "bit-identical")
                    + f" | {card}")
        outs_b, batch_ms = host_ms(lambda: parallel.encode_batch_p010(
            y4k, uv4k, device=dev))
        for i in range(2):
            one = parallel.encode_core_p010(y4k[i], uv4k[i], device=dev)
            if not all(torch.equal(b[i], o) for b, o in zip(outs_b, one)):
                raise AssertionError(f"encode_batch_p010 image {i} != "
                                     "encode_core_p010")
        log(f"phase 17b encode_batch_p010 of two 4K images: {batch_ms:.1f} "
            f"ms, == encode_core_p010 of each | {card}")

        # 17c: the sharded apply at 8K, mesh (1, 4), the one-pass encode's
        # SDR and maps as inputs
        for scale_k, chans in ((1, 3), (1, 1), (4, 1), (4, 3)):
            y8_, u8_, v8_, gm = parallel.encode_core_p010(
                y8k[0], uv8k[0], scale=scale_k, multichannel=chans == 3,
                device=dev)
            sdr = pixel.unpack_yuv8(y8_, u8_, v8_, 2, 2, h8, w8)
            sdr_h, gm_h = sdr.cpu().numpy()[None], gm.cpu().numpy()[None]
            meta = apply_ops.metadata_to_arrays(fused._onepass_metadata(
                port.JpegR(device="cuda"), CT.HLG, True))
            for out_ct in (CT.HLG, CT.LINEAR):
                step = parallel.sharded_apply_step(m14, scale_k=scale_k,
                                                   out_ct=out_ct)
                step(sdr_h, gm_h, meta)
                zero_counts()
                got, step_ms = host_ms(lambda: step(sdr_h, gm_h, meta))
                counts = read_counts(
                    f"sharded apply scale {scale_k} {chans}-channel "
                    f"{out_ct.name} ({mesh_name} mesh)",
                    {"apply_gainmap": 4,
                     "apply_linear": 4 if out_ct == CT.LINEAR else 0})
                sharded_apply_launches += counts["apply_gainmap"]
                sharded_linear_launches += counts["apply_linear"]

                def single():
                    return apply_ops.apply_gainmap_core(
                        pixel.to_device(sdr_h[0], dev),
                        pixel.to_device(gm_h[0], dev), meta, scale_k=scale_k,
                        weight=np.float32(1.0), out_ct=out_ct,
                        sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100,
                        use_base_cg=True)

                single()
                want, single_ms = host_ms(single)
                what = f"sharded apply scale {scale_k} {chans}-channel " \
                    f"{out_ct.name}"
                bit_identical(got.gather(dev)[0], want, what)
                # each shard's apply launch against the plain apply on the
                # shard's SDR rows and its halo-upsampled gain
                rows, m_rows = h8 // 4, gm.shape[1] // 4
                for s in range(4):
                    g = gm[:, s * m_rows:(s + 1) * m_rows].float() / 255.0
                    if scale_k > 1:
                        halo = gm[:, -1:] if s == 3 else \
                            gm[:, (s + 1) * m_rows:(s + 1) * m_rows + 1]
                        g = idw.idw_upsample_sharded(
                            g, halo.float() / 255.0, s == 3, scale_k, rows,
                            w8)
                    bit_identical(got.shards[0][s][0], ak.apply_gainmap_plain(
                        sdr[:, s * rows:(s + 1) * rows].contiguous(),
                        g.contiguous(), ak.meta_to_rows(meta),
                        np.float32(1.0), out_ct=out_ct, sdr_cg=CG.DISPLAY_P3,
                        hdr_cg=CG.BT2100, use_base_cg=True),
                        f"{what}, shard {s} against the plain apply")
                # the step on the card's own tensors: ordered after the
                # stream that wrote them, the same output
                bit_identical(step(sdr[None], gm[None], meta).gather()[0],
                              want, f"{what} from CUDA tensors")
                log(f"phase 17c sharded apply {w8}x{h8} scale {scale_k} "
                    f"{chans}-channel {out_ct.name}, mesh (1, 4) {mesh_name}:"
                    f" {step_ms:.1f} ms against {single_ms:.1f} ms on one "
                    f"device (both from host arrays); bit-identical to it, "
                    f"each shard bit-identical to the plain apply on its "
                    f"rows, and the step from CUDA tensors too | {card}")
        del sdr, sdr_h, gm_h, got, want

        # 17d: the batch decode over a (4, 1) mesh of phase 7's files
        m41 = parallel.make_mesh(4, 1, devs)
        for cfg, ct in (("benchmark", CT.HLG), ("default", CT.LINEAR)):
            jr = port.JpegR(device="cuda")
            zero_counts()
            outs_m, mesh_ms = host_ms(lambda: jr.decode_to_device_batch(
                piped[cfg], ct, mesh=m41))
            counts = read_counts(
                f"mesh batch decode {cfg} {ct.name} ({mesh_name} mesh)",
                {"apply_gainmap": n_img,
                 "apply_linear": n_img if ct == CT.LINEAR else 0})
            sharded_apply_launches += counts["apply_gainmap"]
            sharded_linear_launches += counts["apply_linear"]
            _, plain_ms = host_ms(lambda: jr.decode_to_device_batch(
                piped[cfg], ct))
            for i, ((got_d, _), want_d) in enumerate(zip(
                    outs_m, per_image[cfg, ct])):
                bit_identical(got_d.to(dev), want_d, f"mesh batch decode "
                              f"{cfg} {ct.name} stream {i}")
            log(f"phase 17d decode_to_device_batch {cfg} {ct.name}, mesh "
                f"(4, 1) {mesh_name}: {n_img} streams in {mesh_ms:.1f} ms "
                f"against {plain_ms:.1f} ms without the mesh; every output "
                f"bit-identical to the per-image route | {card}")

    # ---- phase 18: the wire codecs -----------------------------------------
    # every route the JAX package sends over a wire takes the same wire when
    # its knob asks for it (wire.py); unset, each route is raw, and every
    # path above read 0 launches of the two wire kernels.  18a: both wire
    # kernels against their plain versions on edge cases; 18b: 4K encodes
    # over each knob value, byte-identical to the raw files of phases 4 and
    # 4b; 18c: 4K decodes over the coefficient and download wires equal to
    # the raw decodes of phase 5, and the batch decode of phase 7's files
    # equal to phase 8's per-image outputs; 18d: times, each wire beside raw
    from libultrahdr_tpu_torch import wire
    from libultrahdr_tpu_torch.ops import wire_kernel as wk
    before_wires = {
        "pack_scan": p010_launches["pack_scan"] + rgb_launches["pack_scan"]
        + fold_launches["pack_scan"]
        + api1_launches["pack_scan"] + compressed_launches["pack_scan"]
        + pipe_launches + general_input_launches["pack_scan"]
        + fx_enc_launches["pack_scan"] + public_launches["pack_scan"]
        + sharded_pack_launches, "forward_dct": dct_launches[0]}
    log(f"phase 18 launches of phases 3-17, no wire knob set: {before_wires}"
        f" (the apply kernel's below, in the records)")
    wire_knobs = ("UHDR_TPU_WIRE", "UHDR_TPU_WIRE_API1", "UHDR_TPU_WIRE_DOWN",
                  "UHDR_TPU_BATCH_K", "UHDR_TPU_CHUNK_BYTES")
    if any(os.environ.get(k) is not None for k in wire_knobs):
        raise AssertionError(f"a wire knob is set in the environment: "
                             f"{[k for k in wire_knobs if k in os.environ]}")

    @contextlib.contextmanager
    def knobs(**env):
        """The wire knobs set to `env` (the others unset) for the block."""
        os.environ.update(env)
        try:
            yield
        finally:
            for k in wire_knobs:
                os.environ.pop(k, None)

    # 18a: the kernels against their plain versions
    rs = np.random.RandomState(18)

    def rand_words(n):
        return torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, n,
                                           dtype=np.int64)
                                .astype(np.int32)).to(dev)

    n_cases = 0
    for bits in range(2, 9):
        for n in (1, 31, 32, 32 * 1000 + 7):
            pay = rand_words(-(-n // 32) * bits)
            tensors_equal((wk.unslice(pay, n, bits=bits),),
                          (wk.unslice_plain(pay, n, bits=bits),),
                          f"unslice, fixed {bits} bits, {n} samples")
            n_cases += 1
    vw_cases = [rs.randint(0, 16, 37), rs.randint(0, 16, 4099),
                np.zeros(64, np.int64), np.full(64, 12), np.full(9, 15)]
    vw_cases[0][:3] = (0, 12, 0)
    for k, wid in enumerate(vw_cases):
        wid_t = torch.from_numpy(wid.astype(np.int32)).to(dev)
        offs = torch.cumsum(wid_t, 0, dtype=torch.int32) - wid_t
        # the last case's payload ends mid-group: word indices clamp
        live = int(np.minimum(wid, 12).sum())
        pay = rand_words(max(1, live // 2 if k == 1 else live))
        for n in (32 * wid.size, 32 * wid.size - 5):
            tensors_equal(
                (wk.unslice(pay, n, widths=wid_t, offsets=offs),),
                (wk.unslice_plain(pay, n, widths=wid_t, offsets=offs),),
                f"unslice, vw case {k}, {n} samples")
            n_cases += 1

    def down_edge(fmt, h_, w_, noisy):
        """A packed (h_, w_) output, smooth or noisy, whose first and last
        samples jump far from their neighbours."""
        yy, xx = np.mgrid[0:h_, 0:w_]
        chans = [(300 + 2 * xx + yy + c * 50
                  + (rs.randint(0, 400, (h_, w_)) if noisy else 0)) % 1024
                 for c in range(3)]
        for ch in chans:
            ch[0, 0], ch[-1, -1] = 1023, 0
        if fmt == "1010102":
            p = (chans[0] | chans[1] << 10 | chans[2] << 20
                 | 3 << 30).astype(np.uint32)
            return torch.from_numpy(p.view(np.int32)).to(dev)
        comp = np.stack([0x3000 + 16 * c for c in chans]
                        + [np.full((h_, w_), 0x3C00)], -1).astype(np.uint16)
        return torch.from_numpy(comp.view(np.int16)).to(dev)

    over_cap = 0
    for fmt in ("1010102", "f16"):
        for bits in (3, 4, 6, 8):
            for (h_, w_), noisy, cap in (((37, 53), False, wk.DOWN_ESC),
                                         ((64, 32), False, wk.DOWN_ESC),
                                         ((37, 53), True, 16)):
                packed = down_edge(fmt, h_, w_, noisy)
                got = wk.down_pack(packed, bits=bits, cap=cap)
                want = wk.down_pack_plain(packed, bits=bits, cap=cap)
                tensors_equal((got,), (want,), f"down pack {fmt} {bits} "
                              f"bits {h_}x{w_} cap {cap}")
                counts = want[-3:].cpu().numpy()
                nw = -(-h_ * w_ // 32) * bits
                if not noisy and (int(want[nw]) != 0 or int(
                        want[nw + int(counts[0]) - 1]) != h_ * w_ - 1):
                    raise AssertionError("down pack edge case: the first "
                                         "and last samples are not the "
                                         "first and last escapes")
                over_cap += int((counts > cap).any())
                n_cases += 1
    if not over_cap:
        raise AssertionError("down pack edge cases: no count above cap")
    # the seams of the kernels' CTA runs and tiles, each input placed at its
    # alignment (the staged spans' shifts)
    n_seams = 0
    for name_, pay, n, bits, wid, offs, align in \
            testing.unslice_edge_cases():
        pay_t = testing.aligned_tensor(pay, align, dev)
        kw_ = dict(bits=bits)
        if wid is not None:
            wid_t = torch.from_numpy(wid).to(dev)
            kw_ = dict(widths=wid_t, offsets=(
                torch.cumsum(wid_t, 0, dtype=torch.int32) - wid_t
                if offs is None else torch.from_numpy(offs).to(dev)))
        tensors_equal((wk.unslice(pay_t, n, **kw_),),
                      (wk.unslice_plain(pay_t, n, **kw_),),
                      f"unslice, {name_}")
        n_seams += 1
    for name_, packed, bits, cap, align in testing.down_pack_edge_cases():
        packed_t = testing.aligned_tensor(packed, align, dev)
        tensors_equal((wk.down_pack(packed_t, bits=bits, cap=cap),),
                      (wk.down_pack_plain(packed_t, bits=bits, cap=cap),),
                      f"down pack, {name_}")
        n_seams += 1
    n_cases += n_seams
    torch.cuda.synchronize()
    log(f"phase 18a wire kernels == plain (torch.equal) on {n_cases} edge "
        f"cases: unslice at fixed 2-8 bits and vw widths 0-15 (0 and 12 "
        f"groups, n % 32 != 0, a payload shorter than its offsets), the "
        f"download pack of RGBA1010102 and RGBAF16 at 3, 4, 6 and 8 bits "
        f"(escapes at the first and last sample; {over_cap} cases with "
        f"counts above cap), and {n_seams} at the seams of the kernels' "
        f"CTA runs and tiles (testing.unslice_edge_cases, "
        f"down_pack_edge_cases: runs ending mid-span, each alignment, the "
        f"clamp at the payload's end, widths 0 and 12, offsets that are no "
        f"prefix sum, 1x1, h 1, w 1, rows wider than a tile and than the "
        f"halo's room, escapes across a tile boundary, cap inside a tile, "
        f"counts far past cap) | {card}")

    def expected_unslice() -> int:
        """Unslice launches of the wires in wire.RODE: one a vw buffer, one
        a plane on a fixed rung, one a coefficient plane on a bit-slice
        rung (i3, i4, i5: ``wire._unpack_one_n``), none for the 10-bit
        pack, raw or the coefficient wire's other rungs."""
        n = 0
        for key, c in wire.RODE.items():
            route, kind = key.split(":", 1)
            if route == "p010":
                n += c * {"vw": 1, "10bit": 0}.get(kind, 2)
            elif route == "rgb":
                n += c * (0 if kind == "raw" else 3)
            elif route == "api1":
                n += c * {"vw": 1, "raw": 0}.get(kind, 5)
            elif route == "coeff":
                n += c * sum(k in ("i3", "i4", "i5")
                             for k in kind.split(","))
        return n

    def rode() -> str:
        out = ", ".join(f"{k} x{v}" for k, v in sorted(wire.RODE.items()))
        return out or "raw"

    # 18b: 4K encodes over the wires, each byte-identical to raw
    wire_encodes = {}
    zero_counts()
    wire.RODE.clear()
    n_pack = n_unslice = n_join = 0
    for cfg, kw in configs.items():
        for v in ("auto", "vw", "2d5", "1d7"):
            before = dict(wire.RODE)
            with knobs(UHDR_TPU_WIRE=v):
                data = encode(img, kw, f"P010 {cfg} UHDR_TPU_WIRE={v}", "18b")
            took = {k: c - before.get(k, 0) for k, c in wire.RODE.items()
                    if c != before.get(k, 0)}
            if data != outputs[cfg][0]:
                raise AssertionError(f"P010 {cfg} UHDR_TPU_WIRE={v}: file "
                                     "!= the raw route's")
            wire_encodes["P010", cfg, v] = took
            n_pack += 1
            n_join += 1
            log(f"phase 18b P010 {cfg} UHDR_TPU_WIRE={v}: rode {took}, file "
                f"== phase 4's raw file byte for byte")
        for rname in ("RGBA1010102 HLG", "RGBAF16 LINEAR"):
            before = dict(wire.RODE)
            with knobs(UHDR_TPU_WIRE="auto"):
                data = encode(rgb_imgs[rname][0], kw,
                              f"{rname} {cfg} UHDR_TPU_WIRE=auto", "18b")
            took = {k: c - before.get(k, 0) for k, c in wire.RODE.items()
                    if c != before.get(k, 0)}
            if data != rgb_outputs[rname, cfg][0]:
                raise AssertionError(f"{rname} {cfg}: wire file != the raw "
                                     "route's")
            n_pack += 1
            n_join += 1
            log(f"phase 18b {rname} {cfg} UHDR_TPU_WIRE=auto: rode {took}, "
                f"file == phase 4's raw file byte for byte")
        for pname, preset in presets.items():
            for v in ("auto", "h4s3"):
                before = dict(wire.RODE)
                with knobs(UHDR_TPU_WIRE_API1=v):
                    data, _ = request(
                        f"API-1 P010+YUV420 {pname} {cfg} "
                        f"UHDR_TPU_WIRE_API1={v}",
                        api1(img, sdr_img, kw, preset), 1)
                took = {k: c - before.get(k, 0)
                        for k, c in wire.RODE.items()
                        if c != before.get(k, 0)}
                if data != api1_out[pname, cfg, "P010+YUV420"][0]:
                    raise AssertionError(f"API-1 {pname} {cfg} "
                                         f"UHDR_TPU_WIRE_API1={v}: file != "
                                         "the raw route's")
                n_pack += 1
                n_join += 1
                log(f"phase 18b API-1 {pname} {cfg} UHDR_TPU_WIRE_API1={v}:"
                    f" rode {took}, file == phase 4b's raw file byte for "
                    "byte")
    # the pipelined encode over phase 7's eight images, each on its own
    # wire (K-batches of one: phase 22 runs the K-batch route); the files
    # equal phase 7's
    for cfg, kw in configs.items():
        jr = port.JpegR(device="cuda", map_dimension_scale_factor=kw["scale"],
                        use_multi_channel_gainmap=kw["multichannel"])
        for v in ("auto", "vw"):
            with knobs(UHDR_TPU_WIRE=v, UHDR_TPU_BATCH_K="1"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs_w = fused.encode_api0_p010_pipelined(jr, many, 95)
                torch.cuda.synchronize()
                w_ms = (time.perf_counter() - t0) * 1e3
            bad = [i for i, (a, b) in enumerate(zip(outs_w, piped[cfg]))
                   if a != b]
            if bad or len(outs_w) != n_img:
                raise AssertionError(f"pipelined wire encode {cfg}: files "
                                     f"{bad} != phase 7's")
            n_pack += n_img
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused.encode_api0_p010_pipelined(jr, many, 95)
            torch.cuda.synchronize()
            raw_ms = (time.perf_counter() - t0) * 1e3
            n_pack += n_img
            log(f"phase 18b pipelined encode {cfg} UHDR_TPU_WIRE={v}: "
                f"{n_img} images in {w_ms:.1f} ms against {raw_ms:.1f} ms "
                f"for the raw pipelined route right after; every file == "
                f"phase 7's | {card}")
    n_unslice = expected_unslice()
    wire_enc_launches = read_counts("wire encodes", {
        "pack_scan": n_pack, "wire_unslice": n_unslice, "join": n_join})
    log(f"phase 18b wires taken: {rode()}")

    # 18c: 4K decodes over the coefficient and download wires
    def decode_req(data, ct, what, quiet=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = port.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_color_transfer(ct)
        dec.set_out_img_format(fmt_of[ct])
        out = dec.decode().planes[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not quiet:
            log(f"phase 18c decode {what}: {ms:.1f} ms | {card}")
        return out, ms

    zero_counts()
    wire.RODE.clear()
    n_apply = n_linear = n_down = 0
    for cfg in configs:
        for ct in (CT.HLG, CT.LINEAR):
            want = decoded[cfg, ct]
            for env in ({"UHDR_TPU_WIRE": "auto"},
                        {"UHDR_TPU_WIRE_DOWN": "auto"},
                        {"UHDR_TPU_WIRE_DOWN": "4"},
                        {"UHDR_TPU_WIRE_DOWN": "8"}):
                wire._DOWN_STICKY.clear()
                before = dict(wire.RODE)
                with knobs(**env):
                    got, _ = decode_req(outputs[cfg][0], ct,
                                        f"{cfg} {ct.name} {env}")
                took = {k: c - before.get(k, 0) for k, c in wire.RODE.items()
                        if c != before.get(k, 0)}
                if not np.array_equal(testing.host_packed(got),
                                      testing.host_packed(want)):
                    raise AssertionError(f"decode {cfg} {ct.name} {env}: "
                                         "output != the raw decode's")
                n_apply += 1
                n_linear += ct == CT.LINEAR
                if "UHDR_TPU_WIRE_DOWN" in env:
                    # the 1010102 ladder from 4 tries 6 after an overflow
                    auto = env["UHDR_TPU_WIRE_DOWN"] == "auto"
                    n_down += 2 if auto and ct != CT.LINEAR and \
                        "down:4" not in took else 1
                log(f"phase 18c decode {cfg} {ct.name} {env}: rode {took}, "
                    "output == phase 5's raw decode")
    for cfg, ct in (("benchmark", CT.HLG), ("default", CT.LINEAR)):
        jr = port.JpegR(device="cuda")
        with knobs(UHDR_TPU_WIRE="auto"):
            outs_b = jr.decode_to_device_batch(piped[cfg], ct)
        for i, ((got, _), want) in enumerate(zip(outs_b, per_image[cfg, ct])):
            bit_identical(got, want, f"coefficient-wire batch decode {cfg} "
                          f"{ct.name} stream {i}")
        n_apply += n_img
        n_linear += n_img if ct == CT.LINEAR else 0
        log(f"phase 18c batch decode {cfg} {ct.name} UHDR_TPU_WIRE=auto: "
            f"{n_img} streams, every output bit-identical to phase 8's raw "
            f"per-image route")
    wire_dec_launches = read_counts("wire decodes", {
        "apply_gainmap": n_apply, "apply_linear": n_linear,
        "down_pack": n_down, "wire_unslice": expected_unslice()})
    log(f"phase 18c wires taken: {rode()}")

    # 18d: times, each route beside raw (host clock, medians after a warm-up
    # of each; CUDA events for the kernels)
    def med(fn, reps=3):
        fn()
        t = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    def enc_fn(im, kw, env):
        def run():
            with knobs(**env):
                enc = port.UhdrEncoder(device="cuda")
                enc.set_raw_image(im, port.ImgLabel.HDR)
                enc.set_quality(95, port.ImgLabel.BASE)
                enc.set_gainmap_scale_factor(kw["scale"])
                enc.set_using_multi_channel_gainmap(kw["multichannel"])
                enc.encode()
        return run

    def api1_fn(kw, env):
        def run():
            with knobs(**env):
                enc = port.UhdrEncoder(device="cuda")
                api1(img, sdr_img, kw, presets["REALTIME"])(enc)
                enc.encode()
        return run

    def upload_ms(upload):
        """Median ms of upload() and a synchronize, 5 runs."""
        return med(upload, 5)

    rgb_img = rgb_imgs["RGBA1010102 HLG"][0]
    rgb_chans, _ = wire._split_rgb_channels(rgb_img.planes[0],
                                            Fmt.RGBA1010102)
    api1_planes = (p010_planes, [np.asarray(p) for p in sdr_img.planes[:3]])
    for cfg, kw in configs.items():
        for what, raw_fn, wire_fn, pack, raw_arrays in (
                ("P010 UHDR_TPU_WIRE=vw", enc_fn(img, kw, {}),
                 enc_fn(img, kw, {"UHDR_TPU_WIRE": "vw"}),
                 lambda: wire.pack_vw_wire(*p010_planes)[0], p010_planes),
                ("RGBA1010102 UHDR_TPU_WIRE=auto", enc_fn(rgb_img, kw, {}),
                 enc_fn(rgb_img, kw, {"UHDR_TPU_WIRE": "auto"}),
                 lambda: [wire.pack_vw_chan(c) for c in rgb_chans],
                 [rgb_img.planes[0]]),
                ("API-1 REALTIME UHDR_TPU_WIRE_API1=vw", api1_fn(kw, {}),
                 api1_fn(kw, {"UHDR_TPU_WIRE_API1": "vw"}),
                 lambda: wire.pack_api1_vw_wire(*api1_planes[0],
                                                api1_planes[1]),
                 api1_planes[0] + api1_planes[1])):
            bufs = pack()
            bufs = bufs if isinstance(bufs, list) else [bufs]
            pack_ms = med(pack)
            raw_req = [med(raw_fn)]
            wire_req = [med(wire_fn)]
            raw_req.append(med(raw_fn))
            wire_req.append(med(wire_fn))
            log(f"phase 18d {what} {cfg}: request {wire_req[0]:.1f} / "
                f"{wire_req[1]:.1f} ms against raw {raw_req[0]:.1f} / "
                f"{raw_req[1]:.1f} ms (medians of 3, raw and wire in turns);"
                f" host pack {pack_ms:.1f} ms; upload "
                f"{sum(b.nbytes for b in bufs) / 1e6:.2f} MB in "
                f"{upload_ms(lambda: [wire._upload(b, dev) for b in bufs]):.2f}"
                f" ms against raw "
                f"{sum(a.nbytes for a in raw_arrays) / 1e6:.2f} MB in "
                f"{upload_ms(lambda: fused.upload_planes(raw_arrays, dev)):.2f}"
                f" ms | {card}")

    # the wire kernels against the previous design (built from the
    # --previous-wire-kernel source, when given), each alone, in turns:
    # previous, current, current, previous
    prev_unslice = prev_down = None
    if previous_wire_kernel is not None:
        prev_unslice, prev_down = previous_wire_kernels(previous_wire_kernel)

    def in_turns(current, previous):
        """(current ms, previous ms) of two launches alone, each twice, in
        turns; previous None: (current ms twice, None)."""
        if previous is None:
            return [testing.launch_ms(current) for _ in range(2)], None
        a = testing.launch_ms(previous)
        b = [testing.launch_ms(current), testing.launch_ms(current)]
        return b, [a, testing.launch_ms(previous)]

    def launch_split(fn, reps=10) -> str:
        """Device ms of each kernel fn() launches, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = []
        for ev in prof.key_averages():
            m = re.search(r"::(\w+)(<[^>]*>)?\(", ev.key)
            if m and ev.count:
                split.append(f"{m.group(1)} {ev.device_time / 1e3:.4f}")
        return ", ".join(split) or "no device time recorded"

    def turns_text(cur, prev) -> str:
        out = f"{cur[0]:.4f} / {cur[1]:.4f} ms alone"
        if prev is not None:
            out += (f", the previous design {prev[0]:.4f} / {prev[1]:.4f} ms"
                    f" in the same turns")
        return out

    # the unslice kernel on the 4K P010 vw wire
    buf_vw, _ = wire.pack_vw_wire(*p010_planes)
    gy, guv, wyw, wuvw = wire._vw_header_words(h, w)
    buf_d = wire._upload(buf_vw, dev)
    wa = torch.cat([wire._vw_widths(buf_d[:wyw])[:gy],
                    wire._vw_widths(buf_d[wyw:wyw + wuvw])[:guv]])
    wa = wa.to(torch.int32).contiguous()
    offs = torch.cumsum(wa, 0, dtype=torch.int32) - wa
    payload = buf_d[wyw + wuvw:].contiguous()
    n_vw = 32 * wa.numel()
    tensors_equal(
        (wk.unslice(payload, n_vw, widths=wa, offsets=offs),),
        (wk.unslice_plain(payload, n_vw, widths=wa, offsets=offs),),
        "unslice on the 4K P010 vw wire")
    u_bytes = 4 * (int(wa.clamp(max=12).sum()) + 2 * wa.numel() + n_vw)
    # operations: a shift, an and and an or-shift for each word of a
    # sample's group
    u_bound, u_by = bound(u_bytes, 3 * 32 * int(wa.clamp(max=12).sum()))
    u_ms = cuda_ms(lambda: wk.unslice(payload, n_vw, widths=wa,
                                      offsets=offs), 20)
    u_kernel = testing.launch_ms(lambda: wk.UNSLICE_KERNEL(
        payload, n_vw, widths=wa, offsets=offs))
    u_plain = cuda_ms(lambda: wk.unslice_plain(payload, n_vw, widths=wa,
                                               offsets=offs), 3)
    unslice_row = dict(ms=u_ms, kernel_ms=u_kernel, plain_ms=u_plain, err=0,
                       bound_ms=u_bound, bound_by=u_by)
    if prev_unslice is not None:
        tensors_equal((prev_unslice(payload, n_vw, widths=wa, offsets=offs),),
                      (wk.unslice_plain(payload, n_vw, widths=wa,
                                        offsets=offs),),
                      "previous unslice on the 4K P010 vw wire")
    u_cur, u_prev = in_turns(
        lambda: wk.UNSLICE_KERNEL(payload, n_vw, widths=wa, offsets=offs),
        None if prev_unslice is None else
        lambda: prev_unslice(payload, n_vw, widths=wa, offsets=offs))
    log(f"phase 18d unslice kernel, the 4K P010 vw wire ({wa.numel()} "
        f"groups, {buf_vw.nbytes / 1e6:.2f} MB): dispatcher {u_ms:.4f} ms, "
        f"kernel alone {u_kernel:.4f} ms, plain {u_plain:.3f} ms (CUDA "
        f"events), bound {u_bound:.4f} ms ({u_by}, {u_bytes / 1e6:.1f} MB), "
        f"{u_bound / u_kernel:.0%} of it; {turns_text(u_cur, u_prev)} | "
        f"{card}")
    # the fixed rungs at 4K: one RGBA1010102 channel's 4-bit rung and the
    # i4 coefficient rung of the 4K luma plane (seeded words: the fixed
    # path's work does not depend on them)
    for what, n_r, bits_r in (
            ("the 4-bit rung of one RGBA1010102 channel", h * w, 4),
            ("the i4 coefficient rung of the luma plane",
             (h // 8) * (w // 8) * 63, 4)):
        words_r = rand_words(-(-n_r // 32) * bits_r)
        got = wk.unslice(words_r, n_r, bits=bits_r)
        tensors_equal((got,), (wk.unslice_plain(words_r, n_r, bits=bits_r),),
                      f"unslice on {what}")
        if prev_unslice is not None:
            tensors_equal((prev_unslice(words_r, n_r, bits=bits_r),), (got,),
                          f"previous unslice on {what}")
        r_bound, r_by = bound(4 * (words_r.numel() + n_r),
                              3 * 32 * words_r.numel())
        r_ms = cuda_ms(lambda: wk.unslice(words_r, n_r, bits=bits_r), 20)
        r_cur, r_prev = in_turns(
            lambda: wk.UNSLICE_KERNEL(words_r, n_r, bits=bits_r),
            None if prev_unslice is None else
            lambda: prev_unslice(words_r, n_r, bits=bits_r))
        log(f"phase 18d unslice kernel, {what} ({n_r} samples): dispatcher "
            f"{r_ms:.4f} ms, {turns_text(r_cur, r_prev)}, bound "
            f"{r_bound:.4f} ms ({r_by}), {r_bound / min(r_cur):.0%} of it | "
            f"{card}")
        del words_r, got

    def down_times(packed, bits, what):
        """The download pack on one 4K output: == plain (and the previous
        design), dispatcher, alone, in turns with the previous design,
        plain, bound, the launches' split; logs a line, returns the row."""
        got = wk.down_pack(packed, bits=bits)
        tensors_equal((got,), (wk.down_pack_plain(packed, bits=bits),),
                      f"down pack on {what}")
        if prev_down is not None:
            tensors_equal((prev_down(packed, bits=bits),), (got,),
                          f"previous down pack on {what}")
        d_bytes = nbytes(packed, got)
        # operations a sample and channel: the channel (shift, and), the
        # two differences, code = d + half, the range test (two compares),
        # the select of half, the escape count; then a shift, an and and a
        # ballot for each of the code's `bits` bits
        d_bound, d_by = bound(d_bytes, 3 * h * w * (9 + 3 * bits))
        d_ms = cuda_ms(lambda: wk.down_pack(packed, bits=bits), 20)
        d_cur, d_prev = in_turns(
            lambda: wk.DOWN_PACK_KERNEL(packed, bits=bits),
            None if prev_down is None else
            lambda: prev_down(packed, bits=bits))
        d_plain = cuda_ms(lambda: wk.down_pack_plain(packed, bits=bits), 3)
        split = launch_split(lambda: wk.DOWN_PACK_KERNEL(packed, bits=bits))
        log(f"phase 18d download pack kernel, {what} at {bits} bits "
            f"(escapes {got[-3:].cpu().tolist()}): dispatcher {d_ms:.4f} ms, "
            f"{turns_text(d_cur, d_prev)}, plain {d_plain:.3f} ms (CUDA "
            f"events), bound {d_bound:.4f} ms ({d_by}, {d_bytes / 1e6:.1f} "
            f"MB), {d_bound / min(d_cur):.0%} of it; launches (torch."
            f"profiler, ms): {split} | {card}")
        return dict(ms=d_ms, kernel_ms=d_cur[0], plain_ms=d_plain, err=0,
                    bound_ms=d_bound, bound_by=d_by), got

    # decodes: the coefficient wire and the download wire beside raw
    for cfg in configs:
        data = outputs[cfg][0]
        primary, pinfo, gm_jpeg, gm_info, *_ = \
            port.JpegR(device="cuda")._parse_jpegr(data)
        coeffs = fused.decode_coefficients(primary, pinfo)[0] \
            + fused.decode_coefficients(gm_jpeg, gm_info)[0]
        blob = wire.pack_coeff_blob(coeffs, stage=True)
        c_pack = med(lambda: wire.pack_coeff_blob(coeffs, stage=True))
        def hlg_decode():
            decode_req(data, CT.HLG, "", quiet=True)

        raw_t = med(hlg_decode)
        with knobs(UHDR_TPU_WIRE="auto"):
            wire_t = med(hlg_decode)
        log(f"phase 18d coefficient wire {cfg} HLG ({blob[1]}): request "
            f"{wire_t:.1f} ms against raw {raw_t:.1f} ms (medians of 3); "
            f"host pack {c_pack:.1f} "
            f"ms; upload {blob[0].numel() / 1e6:.2f} MB in "
            f"{upload_ms(lambda: pixel.to_device(blob[0], dev)):.2f} ms "
            f"against raw {sum(c.nbytes for c in coeffs) / 1e6:.2f} MB in "
            f"{upload_ms(lambda: fused.upload_coeff_planes(coeffs, dev)):.2f}"
            f" ms | {card}")
        for ct, bits, fetch in ((CT.HLG, 4, wire.fetch_packed_1010102),
                                (CT.LINEAR, 8, wire.fetch_packed_f16)):
            packed = torch.from_numpy(testing.host_packed(decoded[cfg, ct])
                                      .view(np.int32 if ct == CT.HLG
                                            else np.int16)).to(dev)
            with knobs(UHDR_TPU_WIRE_DOWN=str(bits)):
                got = fetch(packed, h=h, w=w)
                down_ms = med(lambda: fetch(packed, h=h, w=w))
            if not np.array_equal(got, testing.host_packed(decoded[cfg, ct])):
                raise AssertionError(f"download wire {cfg} {ct.name} != raw")
            raw_down = med(lambda: packed.cpu())
            row, wire_buf = down_times(
                packed, bits, f"the decoded 4K {cfg} {ct.name} output")
            if cfg == "default" and ct == CT.HLG:
                down_row = row
            log(f"phase 18d download wire {cfg} {ct.name} at {bits} bits: "
                f"{wire_buf.numel() * 4 / 1e6:.2f} MB (escapes "
                f"{wire_buf[-3:].cpu().tolist()}) fetched in {down_ms:.2f} ms "
                f"against raw {nbytes(packed) / 1e6:.2f} MB in "
                f"{raw_down:.2f} ms (.cpu(), the default route) | {card}")
    # the download wire where it fits: a smooth 4K output (the decodes above
    # overflow every width's escape list and go raw)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = [(xx // 8 + yy // 8 + 64 * c_) % 1024 for c_ in range(3)]
    for ct, bits, fetch, host in (
            (CT.HLG, 4, wire.fetch_packed_1010102,
             (smooth[0] | smooth[1] << 10 | smooth[2] << 20 | 3 << 30)
             .astype(np.uint32)),
            (CT.LINEAR, 8, wire.fetch_packed_f16,
             np.stack([0x3000 + 4 * s for s in smooth]
                      + [np.full((h, w), 0x3C00)], -1).astype(np.uint16))):
        packed = torch.from_numpy(host.view(
            np.int32 if ct == CT.HLG else np.int16)).to(dev)
        wire.RODE.clear()
        with knobs(UHDR_TPU_WIRE_DOWN=str(bits)):
            if not np.array_equal(fetch(packed, h=h, w=w), host):
                raise AssertionError(f"download wire, smooth {ct.name} != "
                                     "raw")
            if dict(wire.RODE) != {f"down:{bits}": 1}:
                raise AssertionError(f"smooth {ct.name}: not on the wire "
                                     f"({dict(wire.RODE)})")
            down_ms = med(lambda: fetch(packed, h=h, w=w))
        raw_down = med(lambda: packed.cpu())
        _, wire_buf = down_times(packed, bits,
                                 f"a smooth 4K {ct.name} output")
        log(f"phase 18d download wire, a smooth 4K {ct.name} output at "
            f"{bits} bits (it fits): {wire_buf.numel() * 4 / 1e6:.2f} MB "
            f"(escapes {wire_buf[-3:].cpu().tolist()}) fetched and unpacked "
            f"in {down_ms:.2f} ms against raw {nbytes(packed) / 1e6:.2f} MB "
            f"in {raw_down:.2f} ms (.cpu()) | {card}")
    del buf_d, payload, packed, wire_buf, yy, xx, smooth

    # ---- phase 19: the C ABI on the card ----------------------------------
    # UHDR_TPU_TORCH_DEVICE unset: every codec of the shim on the card.
    # (a) stand-alone C programs on the shim linked against libpython, each
    # a process of its own; (b) the shim built for a running interpreter,
    # loaded here with ctypes.CDLL, whose launches this process counts
    import sysconfig
    import tempfile
    from libultrahdr_tpu_torch.capi import abi as capi_abi
    if os.environ.get("UHDR_TPU_TORCH_DEVICE"):
        raise AssertionError("UHDR_TPU_TORCH_DEVICE is set: the C ABI's "
                             "codecs must run on their default device")
    log(f"phase 19 Python {sys.version.split()[0]} at {sys.prefix}: "
        f"Py_ENABLE_SHARED {sysconfig.get_config_var('Py_ENABLE_SHARED')}, "
        f"LDLIBRARY {sysconfig.get_config_var('LDLIBRARY')}, LIBDIR "
        f"{sysconfig.get_config_var('LIBDIR')}; shims {capi_shim.name} "
        f"(linked), {capi_inproc_shim.name} (for ctypes.CDLL)")
    torch.cuda.empty_cache()
    c_env = capi_build.embed_env()
    tmp19 = tempfile.TemporaryDirectory()
    d19 = pathlib.Path(tmp19.name)
    (d19 / "in.p010").write_bytes(p010_planes[0].tobytes()
                                  + p010_planes[1].tobytes())
    r = subprocess.run([str(capi_test_exe)], env=c_env, capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0 or "capi round-trip OK" not in r.stdout:
        raise AssertionError(f"test_capi: exit {r.returncode}\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
    log(f"phase 19a test_capi.c (64x48 walkthrough) on the card: exit 0, "
        f"{r.stdout.strip()} | {card}")
    first_call = {}
    for cfg, kw in configs.items():
        threads = 2 if cfg == "default" else 1
        t0 = time.perf_counter()
        r = subprocess.run(
            [str(capi_roundtrip_exe), str(d19 / "in.p010"), str(w), str(h),
             str(kw["scale"]), str(int(kw["multichannel"])), "95",
             str(d19 / cfg), str(threads)],
            env=c_env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"capi_roundtrip {cfg}: exit {r.returncode}"
                                 f"\n{r.stdout}\n{r.stderr[-4000:]}")
        steps = {k: float(v) for k, v in
                 re.findall(r"^ms (\S+) ([0-9.]+)$", r.stdout, re.M)}
        files = [d19 / f"{cfg}.jpg"] + [d19 / f"{cfg}.t{i}.jpg"
                                         for i in range(threads)
                                         if threads > 1]
        if any(f.read_bytes() != outputs[cfg][0] for f in files):
            raise AssertionError(f"capi_roundtrip {cfg}: a file != phase 4's "
                                 "UhdrEncoder file")
        for ct, tag in ((CT.HLG, "hlg"), (CT.LINEAR, "linear")):
            if (d19 / f"{cfg}.{tag}.raw").read_bytes() != \
                    testing.host_packed(decoded[cfg, ct]).tobytes():
                raise AssertionError(f"capi_roundtrip {cfg}: {tag} decode != "
                                     "phase 5's UhdrDecoder output")
        first_call[cfg] = steps
        log(f"phase 19a capi_roundtrip {cfg} (a new process, {threads} "
            f"encoding thread(s) first): {len(files)} file(s) == phase 4's "
            f"UhdrEncoder file, HLG and LINEAR raw == phase 5's outputs; "
            f"process {wall:.2f} s; host ms: init (interpreter start, import "
            f"of torch and the port) {steps['init']:.1f}, create_encoder "
            f"{steps['create_encoder']:.1f}, create_decoder "
            f"{steps['create_decoder']:.1f}, encode {steps['encode']:.1f} "
            f"(uhdr_encode {steps['encode.uhdr_encode']:.1f}), decode_hlg "
            f"{steps['decode_hlg']:.1f}, decode_linear "
            f"{steps['decode_linear']:.1f} | {card}")
    tmp19.cleanup()

    # (b) in process
    c_lib = capi_abi.load(capi_inproc_shim)
    y_c, uv_c = (np.ascontiguousarray(p) for p in p010_planes)
    zero_counts()
    c_files, c_decoded = {}, {}
    for cfg, kw in configs.items():
        c_files[cfg] = capi_abi.encode_p010(c_lib, y_c, uv_c, **kw)
        for ct in (CT.HLG, CT.LINEAR):
            c_decoded[cfg, ct] = capi_abi.decode(c_lib, c_files[cfg],
                                                 fmt_of[ct], ct)
    capi_launches = [read_counts("C ABI in process", {
        "pack_scan": 2, "apply_gainmap": 4, "apply_linear": 2})]
    for cfg in configs:
        if c_files[cfg] != outputs[cfg][0]:
            raise AssertionError(f"C ABI {cfg}: file != UhdrEncoder's")
        for ct in (CT.HLG, CT.LINEAR):
            if not np.array_equal(c_decoded[cfg, ct],
                                  testing.host_packed(decoded[cfg, ct])):
                raise AssertionError(f"C ABI {cfg} {ct.name}: decode != "
                                     "UhdrDecoder's")
    zero_counts()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(capi_abi.encode_p010, c_lib, y_c, uv_c,
                            **configs["benchmark"]) for _ in range(2)]
        c_threads = [f.result() for f in futs]
    capi_launches.append(read_counts("C ABI from two Python threads",
                                     {"pack_scan": 2}))
    if any(f != outputs["benchmark"][0] for f in c_threads):
        raise AssertionError("C ABI from two threads: a file != UhdrEncoder's")
    log(f"phase 19b C ABI in process (ctypes.CDLL): both configurations' "
        f"files == UhdrEncoder's, HLG and LINEAR decodes == UhdrDecoder's, "
        f"two threads' files == UhdrEncoder's | {card}")

    def direct_encode(kw):
        enc = port.UhdrEncoder(device="cuda")
        enc.set_raw_image(img, port.ImgLabel.HDR)
        enc.set_gainmap_scale_factor(kw["scale"])
        enc.set_using_multi_channel_gainmap(kw["multichannel"])
        enc.set_quality(95, port.ImgLabel.BASE)
        return enc.encode()

    def direct_decode(data, ct):
        dec = port.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_img_format(fmt_of[ct])
        dec.set_out_color_transfer(ct)
        return dec.decode().planes[0]

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    capi_ms = {}
    zero_counts()
    for cfg, kw in configs.items():
        data = outputs[cfg][0]
        routes = [("encode",
                   lambda kw=kw: capi_abi.encode_p010(c_lib, y_c, uv_c, **kw),
                   lambda kw=kw: direct_encode(kw))]
        for ct in (CT.HLG, CT.LINEAR):
            routes.append((
                f"{ct.name} decode",
                lambda data=data, ct=ct: capi_abi.decode(c_lib, data,
                                                         fmt_of[ct], ct),
                lambda data=data, ct=ct: direct_decode(data, ct)))
        for what, c_fn, py_fn in routes:
            c_fn(), py_fn()      # warm-up
            c_t, py_t = [], []
            turns = [(c_fn, c_t), (py_fn, py_t)]
            for rep in range(3):   # in turns: C, direct, direct, C, C, direct
                for fn, into in turns if rep % 2 == 0 else turns[::-1]:
                    into.append(host_ms(fn))
            capi_ms[cfg, what] = (float(np.median(c_t)),
                                  float(np.median(py_t)))
            log(f"phase 19b {cfg} {what}: C ABI {capi_ms[cfg, what][0]:.1f} "
                f"ms against the direct call {capi_ms[cfg, what][1]:.1f} ms "
                f"({capi_ms[cfg, what][0] - capi_ms[cfg, what][1]:+.1f}; host "
                f"clock medians of 3 in turns after a warm-up; C "
                f"{', '.join(f'{t:.1f}' for t in c_t)}, direct "
                f"{', '.join(f'{t:.1f}' for t in py_t)}) | {card}")
    capi_launches.append(read_counts("C ABI beside the direct calls", {
        "pack_scan": 16, "apply_gainmap": 32, "apply_linear": 16}))
    capi_total = {k: sum(c[k] for c in capi_launches)
                  for k in capi_launches[0]}
    steady = capi_ms["benchmark", "encode"][0]
    log(f"phase 19 first call in a new process (capi_roundtrip benchmark): "
        f"interpreter start and import of torch and the port "
        f"{first_call['benchmark']['init']:.1f} ms, uhdr_create_encoder "
        f"{first_call['benchmark']['create_encoder']:.1f} ms, the first "
        f"encode {first_call['benchmark']['encode']:.1f} ms against "
        f"{steady:.1f} ms warm in process ("
        f"{first_call['benchmark']['encode'] - steady:+.1f}: CUDA context, "
        f"the kernel libraries' load, device tables); phase 19 launches "
        f"{capi_total} | {card}")

    # ---- phase 20: the hardening gates --------------------------------------
    # 20a: every kernel through its wrapper, == its plain version, in
    # children: under compute-sanitizer's four tools (PyTorch's caching
    # allocator off, so that each tensor is an allocation the tool can
    # bound), then under the guard-page allocator (tools/guard_alloc.cpp:
    # an unmapped granule after, then before, every tensor, new memory
    # filled with 0xA5, then 0x5A) and eight runs a case beside a busy
    # stream; 20b: the card's decode against the CPU's on 2,000 seeded
    # mutants (fuzz/differential.py, in a child), then phase 4's files
    # decoded again in this process
    from libultrahdr_tpu_torch import _buildlib
    from libultrahdr_tpu_torch.fuzz import differential
    from libultrahdr_tpu_torch.tools import sanitize_kernels as sk
    t20 = time.perf_counter()
    sanitizer = pathlib.Path(_buildlib.nvcc()).resolve().parent \
        / "compute-sanitizer"
    if not sanitizer.is_file():
        raise AssertionError(f"no compute-sanitizer beside nvcc: {sanitizer}")
    kmod = [sys.executable, "-m",
            "libultrahdr_tpu_torch.tools.sanitize_kernels"]
    tmp20 = tempfile.TemporaryDirectory()

    def children(runs: dict) -> dict:
        """Start every child of `runs` (name -> (argv, env)) at once, each
        writing to a file of its own; (exit code, output, seconds) each."""
        procs = {}
        for i, (what, (argv, env)) in enumerate(runs.items()):
            out = open(pathlib.Path(tmp20.name) / f"{i}.log", "w+")
            proc = subprocess.Popen(argv, env=env, stdout=out, cwd=HERE,
                                    stderr=subprocess.STDOUT)
            procs[what] = (proc, out, time.perf_counter())
        done = {}
        while len(done) < len(procs):
            for what, (proc, out, t0) in procs.items():
                if what in done:
                    continue
                if proc.poll() is None and time.perf_counter() - t0 > 600:
                    proc.kill()
                    proc.wait()
                if proc.poll() is not None:
                    out.seek(0)
                    done[what] = (proc.returncode, out.read(),
                                  time.perf_counter() - t0)
                    out.close()
            time.sleep(0.05)
        return done

    def kernel_json(what, rc, text) -> dict:
        """The child's last line: its per-kernel record; every kernel
        launched and == plain, else the phase fails."""
        lines = text.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, ValueError):
            rec = None
        if rc != 0 or rec is None or any(
                st["launches"] == 0 for st in rec["kernels"].values()):
            raise AssertionError(f"phase 20a {what}: exit {rc}\n"
                                 + "\n".join(lines[-40:]))
        return rec

    san_env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    san_runs = children({t: ([str(sanitizer), "--tool", t, "--error-exitcode",
                              "1", *kmod, "--tool", t], san_env)
                         for t in sk.TOOLS})
    refused = []
    for tool, (rc, text, secs) in san_runs.items():
        if "Error: Device not supported" in text:
            # the tool's own refusal, before any kernel ran: recorded, and
            # the guard runs below stand in for it
            refused.append(tool)
            first = [ln for ln in text.splitlines()
                     if ln.startswith("=") and ln.strip("= ")][:2]
            log(f"phase 20a compute-sanitizer --tool {tool}: REFUSED the "
                f"device, no kernel ran under it (exit {rc}, {secs:.1f} s): "
                f"{' | '.join(first)} | {card}")
            continue
        summary = re.findall(r"(?:ERROR|RACECHECK) SUMMARY: .*", text)
        errors = sum(int(a or b) for a, b in re.findall(
            r"ERROR SUMMARY: (\d+) error|\((\d+) errors?,", text))
        rec = kernel_json(f"compute-sanitizer --tool {tool}", rc, text)
        if not summary or errors:
            raise AssertionError(f"phase 20a compute-sanitizer --tool {tool}:"
                                 f" {summary}\n{text[-6000:]}")
        log(f"phase 20a compute-sanitizer --tool {tool}: {summary[-1]}, "
            f"{secs:.1f} s, {rec['shapes']} shapes | {card}")
        for k, st in rec["kernels"].items():
            log(f"phase 20a   {tool} {k}: {st['cases']} cases, "
                f"{st['launches']} launches, 0 errors, {st['seconds']:.2f} s, "
                "== plain")
    guard_runs = children({
        "guard right 0xA5": ([*kmod, "--guard", "right", "--fill", "0xA5"],
                             dict(os.environ)),
        "guard left 0x5A": ([*kmod, "--guard", "left", "--fill", "0x5A"],
                            dict(os.environ)),
        "repeat 8": ([*kmod, "--repeat", "8"], dict(os.environ))})
    for what, (rc, text, secs) in guard_runs.items():
        rec = kernel_json(what, rc, text)
        extra = f", {rec['guard']['allocations']} guarded allocations" \
            if "guard" in rec else ""
        log(f"phase 20a {what}: exit 0, no fault, {rec['shapes']} shapes, "
            f"{secs:.1f} s{extra} | {card}")
        for k, st in rec["kernels"].items():
            log(f"phase 20a   {what} {k}: {st['cases']} cases, "
                f"{st['launches']} launches, {st['seconds']:.2f} s, == plain")
    tmp20.cleanup()
    t20a = time.perf_counter() - t20

    # 20b: the card fuzz
    zero_counts()
    t0 = time.perf_counter()
    fuzz = differential.run(2000, seed=20, device="cuda",
                            reference_device="cpu", timeout=900)
    fuzz_wall = time.perf_counter() - t0
    if not fuzz["ok"]:
        raise AssertionError(
            f"phase 20b card fuzz: exit {fuzz['returncode']}, crash on "
            f"mutant {fuzz['crash']}, faults {fuzz['faults_seen'][:5]}, "
            f"kept {fuzz['saved']}\n{fuzz.get('stderr', '')}")
    read_counts("card fuzz (in its child; none here)", {})
    child_launches = fuzz["launches"]     # per kernel, sanitize_kernels' keys
    # a stacked mutation may take a seed's DRI away: its scans then go to
    # the card's entropy decoder
    if child_launches["apply_gainmap"] == 0 or any(
            n for k, n in child_launches.items()
            if not k.startswith("apply_gainmap") and k != "huffman"):
        raise AssertionError(f"phase 20b card fuzz launches {child_launches}")
    fuzz_launches = {   # read_counts' keys: apply_gainmap counts both
        "apply_gainmap": child_launches["apply_gainmap"]
        + child_launches["apply_gainmap_linear"],
        "apply_linear": child_launches["apply_gainmap_linear"]}
    log(f"phase 20b card fuzz (fuzz/differential.py, seed 20): "
        f"{fuzz['execs']} mutants decoded on the card and the CPU to HLG "
        f"and LINEAR: accepted {fuzz['accepted']}, rejected "
        f"{fuzz['rejected']} (coded UhdrError on both), 0 faults, no CUDA "
        f"error; {fuzz['ms_per_mutant']:.2f} ms a mutant (four decodes), "
        f"child {fuzz['seconds']:.1f} s, {fuzz_wall:.1f} s with its start; "
        f"launches in the child {child_launches} | {card}")
    zero_counts()
    for cfg in configs:
        for ct in (CT.HLG, CT.PQ, CT.LINEAR):
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(outputs[cfg][0])
            dec.set_out_color_transfer(ct)
            dec.set_out_img_format(fmt_of[ct])
            if not np.array_equal(testing.host_packed(dec.decode().planes[0]),
                                  testing.host_packed(decoded[cfg, ct])):
                raise AssertionError(f"phase 20b: {cfg} {ct.name} decode "
                                     "after the card fuzz != phase 5's")
    redecode_launches = read_counts("4K decodes after the card fuzz", {
        "apply_gainmap": 6, "apply_linear": 2})
    t20_total = time.perf_counter() - t20
    log(f"phase 20b phase 4's two files decoded again to HLG, PQ and LINEAR"
        f": == phase 5's outputs, bit for bit; phase 20: {t20_total:.1f} s "
        f"(20a {t20a:.1f} s, compute-sanitizer refused by {refused or 'none'}"
        f") | {card}")

    # ---- phase 21: the benchmark tools ------------------------------------
    # tools/benchmarks.py (every section at 3840x2160, 3 reps) and
    # tools/bench.py (the headline) in this process, through the public
    # API; each row zeroes the launch counts before it and reads them after,
    # and must agree with phases 4-5: one pack and two scan-kernel launches
    # a fused encode, one apply launch an HLG/PQ/LINEAR decode on the card,
    # none on SRGB or the host engine.  The scan recorder is set aside: the
    # rows are timed, and phases 3-20 held the scan kernel to its plain
    # version on every path
    import io
    from libultrahdr_tpu_torch.tools import bench as bench_tool
    from libultrahdr_tpu_torch.tools import benchmarks as bm_tool
    t21 = time.perf_counter()
    dct.scan_inputs = real_scan_inputs
    jpeg_encoder.forward_plane = real_forward_plane

    def run_tool(main, argv) -> tuple[int, str]:
        """main(argv) with its standard output captured (printed if it
        raises)."""
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
        except BaseException:
            log(buf.getvalue())
            raise
        return rc, buf.getvalue()

    def row_expect(row: dict) -> dict:
        """The launches a row must read, from its config and calls."""
        n, cfg = row["calls"], row["config"]
        if cfg.startswith("enc"):
            return {"pack_scan": n, "forward_dct": 2 * n, "join": n}
        if cfg.endswith("(host)") or "-> srgb" in cfg:
            return {}
        return {"apply_gainmap": n, "apply_linear": n * ("-> linear" in cfg)}

    tools_launches = dict.fromkeys(counted, 0)
    tools_launches["apply_linear"] = 0
    with tempfile.TemporaryDirectory() as tmp21:
        art = pathlib.Path(tmp21) / "benchmarks.json"
        rc, _ = run_tool(bm_tool.main, ["--size", f"{w}x{h}", "--reps", "3",
                                        "--json", str(art)])
        matrix = json.loads(art.read_text())
    for row in matrix["rows"]:
        want = row_expect(row)
        got = row["launches"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"phase 21 {row['config']}: launches "
                                 f"{got}, expected {want} for "
                                 f"{row['calls']} calls")
        for k in tools_launches:
            tools_launches[k] += got[k]
        log(f"phase 21 row {row['config']} | {row['scene']} "
            f"{row['resolution']}: {row['ms']:.3f} ms median of {row['n']} "
            f"(min {row['min_ms']:.3f}, max {row['max_ms']:.3f}), "
            f"{row['mp_per_s']:.3f} MP/s; checks failed {row['failed']} of "
            f"{row['attempted']}; launches "
            f"{ {k: v for k, v in got.items() if v} } in {row['calls']} "
            "calls")
    failed = [r["config"] for r in matrix["rows"] if r["failed"]]
    if rc != 0 or failed:
        raise AssertionError(f"phase 21 benchmarks: exit {rc}, rows failed "
                             f"{failed}")
    t21a = time.perf_counter() - t21
    rc, out = run_tool(bench_tool.main, [])
    headline = json.loads(out.strip().splitlines()[-1])
    log(json.dumps(headline))
    extra = headline["extra"]
    n_enc = extra["encode_calls"]
    if rc != 0 or not extra["pipelined_equal_single"] or \
            extra["launches"] != {k: {"pack_scan": n_enc,
                                      "forward_dct": 2 * n_enc}.get(k, 0)
                                  for k in extra["launches"]}:
        raise AssertionError(f"phase 21 bench: exit {rc}, launches "
                             f"{extra['launches']} for {n_enc} images")
    for k in tools_launches:
        tools_launches[k] += extra["launches"][k]
    dct_launches[0] += tools_launches["forward_dct"]
    log(f"phase 21 the benchmark tools: {len(matrix['rows'])} rows of "
        f"tools/benchmarks.py at {matrix['resolution']} ({t21a:.1f} s), "
        f"every check passed and every row's launches as phases 4-5 count "
        f"them; tools/bench.py: {n_enc} pipelined files == encode_api0, "
        f"{extra['launches']['pack_scan']} pack launches; phase 21: "
        f"{time.perf_counter() - t21:.1f} s | {card}")

    # ---- phase 22: the K-batch route --------------------------------------
    # with UHDR_TPU_WIRE set the pipelined encode chunks uniform images into
    # K-batches (fused._batches, the JAX package's chunking): one stacked
    # upload, each image's stages and pack on a row of its own, one stitch
    # (csrc/stitch_kernel.cu), one download.  22a the stitch against its
    # plain version on edge cases; 22b the 8 rolled 4K photos of
    # tools/bench.py over vw (K = 2 at the default chunk bytes, K = 8),
    # over 1d7 (every photo overflows every delta rung's escapes and goes
    # up alone over the dense 10-bit pack, as in the JAX package) and with
    # a non-uniform image, and 8 rolled 4K mosaics over 2d6 (K = 2), each
    # file == its single encode; the stitch of a K = 2 and a K = 8 batch
    # against its plain version on the slot's own rows, timed alone; 22c
    # ms an image in turns
    t22 = time.perf_counter()
    n_edge = 0
    for cname, room_np, counts_np in testing.stitch_edge_cases():
        room = torch.from_numpy(room_np).to(dev)
        counts = torch.from_numpy(counts_np.astype(np.int64)).to(dev)
        total = int(np.clip(counts_np, 0, room_np.shape[1]).sum())
        tensors_equal((stk.stitch(room, counts)[:total],),
                      (stk.stitch_plain(room, counts)[:total],),
                      f"phase 22a stitch kernel on {cname}")
        n_edge += 1
    log(f"phase 22a stitch kernel == plain (torch.equal on the live words) "
        f"on {n_edge} edge cases (testing.stitch_edge_cases: k = 1, images "
        f"of 0 live words first, between and last, odd counts, every total "
        f"mod 4, full rows, clamped counts, a pitch no multiple of 4, 64 "
        f"images) | {card}")

    k_imgs = bench_tool._scene_imgs(bm_tool.photo_p010, w=w, h=h)
    odd = port.RawImage(Fmt.P010, CG.BT2100, CT.PQ, port.ColorRange.FULL,
                        w, h, [p.copy() for p in k_imgs[3].planes])
    jr22 = port.JpegR(device="cuda", map_dimension_scale_factor=4,
                      use_multi_channel_gainmap=False, preset=0)
    zero_counts()
    singles = [jr22.encode_api0(im, 95) for im in k_imgs]
    odd_single = jr22.encode_api0(odd, 95)
    kb_launches = read_counts("phase 22 single encodes", {"pack_scan": 9})
    kb_env = {"raw": {}, "per-image vw": {"UHDR_TPU_WIRE": "vw",
                                          "UHDR_TPU_BATCH_K": "1"},
              "K-batch vw": {"UHDR_TPU_WIRE": "vw"},
              "K-batch vw, chunk 1e9": {"UHDR_TPU_WIRE": "vw",
                                        "UHDR_TPU_CHUNK_BYTES": "1e9"},
              "K-batch 1d7": {"UHDR_TPU_WIRE": "1d7"}}
    units = {}
    for what, env in kb_env.items():
        with knobs(**env):
            units[what] = [len(u) for u, _ in fused._batches(k_imgs)]

    def batches(what) -> int:
        return sum(n > 1 for n in units[what])

    def add(total: dict, got: dict):
        for kname, n in got.items():
            total[kname] = total.get(kname, 0) + n

    def kb_run(what, imgs, env, want, n_batches, time_it=False):
        """One pipelined encode of `imgs` under `env`; every file == `want`
        and the launches as its batches imply; host ms if `time_it`."""
        wire.RODE.clear()
        zero_counts()
        with knobs(**env):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs_k = fused.encode_api0_p010_pipelined(jr22, imgs, 95)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        bad = [i for i, (a, b) in enumerate(zip(outs_k, want)) if a != b]
        if bad or len(outs_k) != len(want):
            raise AssertionError(f"phase 22 {what}: files {bad} != the "
                                 "single encodes")
        add(kb_launches, read_counts(
            f"phase 22 {what}", {"pack_scan": len(imgs), "join": 0,
                                 "wire_unslice": expected_unslice(),
                                 "stitch": n_batches}))
        if not time_it:
            log(f"phase 22b {what}: units {units.get(what)}, rode {rode()},"
                f" {len(imgs)} files == their single encode_api0, "
                f"{n_batches} stitch launches, {ms:.1f} ms | {card}")
        return ms

    def stitch_row(what):
        """The stitch of the last batch on slot 0 against its plain version
        on the slot's own rows, and against the route's output; timed."""
        scratch, _, room, out, _ = fused._SLOTS[dev][0].batch_bufs
        counts = scratch[:, 1]
        total = int(counts.sum())
        out2 = torch.empty_like(out)
        want = stk.stitch_plain(room, counts)[:total]
        tensors_equal((stk.stitch(room, counts, out2)[:total],), (want,),
                      f"phase 22b stitch kernel on {what}")
        tensors_equal((out[:total],), (want,),
                      f"phase 22b the route's stitch on {what}")
        s_bound, s_by = bound(8 * total + 8 * room.shape[0], 0)
        row = dict(
            ms=cuda_ms(lambda: stk.stitch(room, counts, out2), 20),
            kernel_ms=testing.launch_ms(
                lambda: stk.STITCH_KERNEL.launch(room, counts, out2)),
            plain_ms=cuda_ms(lambda: stk.stitch_plain(room, counts), 3),
            bound_ms=s_bound, bound_by=s_by, err=0, k=room.shape[0],
            live_mb=4 * total / 1e6)
        log(f"phase 22b stitch of {what}: k {row['k']}, "
            f"{row['live_mb']:.2f} MB of live words, kernel == plain "
            f"(torch.equal) and == the route's output; wrapper "
            f"{row['ms']:.4f} ms, kernel alone {row['kernel_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.3f} ms, bound {s_bound:.4f} ms "
            f"({s_by}, {100 * s_bound / row['kernel_ms']:.0f}%) | {card}")
        return row

    kb_run("raw", k_imgs, kb_env["raw"], singles, 0)
    kb_run("per-image vw", k_imgs, kb_env["per-image vw"], singles, 0)
    kb_run("K-batch vw", k_imgs, kb_env["K-batch vw"], singles,
           batches("K-batch vw"))
    stitch_rows = {"K = 2": stitch_row("a K-batch of the vw run")}
    kb_run("K-batch vw, chunk 1e9", k_imgs, kb_env["K-batch vw, chunk 1e9"],
           singles, batches("K-batch vw, chunk 1e9"))
    stitch_rows["K = 8"] = stitch_row("the K = 8 batch")
    kb_run("K-batch 1d7", k_imgs, kb_env["K-batch 1d7"], singles,
           batches("K-batch 1d7"))
    mosaics = bench_tool._scene_imgs(bm_tool.natural_p010, w=w, h=h)
    zero_counts()
    mosaic_singles = [jr22.encode_api0(im, 95) for im in mosaics]
    add(kb_launches, read_counts("phase 22 single mosaic encodes",
                                 {"pack_scan": len(mosaics)}))
    with knobs(UHDR_TPU_WIRE="2d6"):
        units["K-batch 2d6 (mosaic)"] = [
            len(u) for u, _ in fused._batches(mosaics)]
    kb_run("K-batch 2d6 (mosaic)", mosaics, {"UHDR_TPU_WIRE": "2d6"},
           mosaic_singles, batches("K-batch 2d6 (mosaic)"))
    mixed = k_imgs[:3] + [odd] + k_imgs[3:]
    with knobs(**kb_env["K-batch vw, chunk 1e9"]):
        mixed_units = list(fused._batches(mixed))
    units["non-uniform"] = [len(u) for u, _ in mixed_units]
    kb_run("non-uniform", mixed, kb_env["K-batch vw, chunk 1e9"],
           singles[:3] + [odd_single] + singles[3:], batches("non-uniform"))
    # the rolled photos' vw wires may round to different buckets, which
    # ends a batch as in the JAX package; the knobs must still give K = 2
    # and larger batches, and the PQ image a unit of its own
    if max(units["K-batch vw"]) != 2 \
            or max(units["K-batch vw, chunk 1e9"]) <= 2 \
            or max(units["K-batch 2d6 (mosaic)"]) != 2 \
            or not any(u == [odd] for u, _ in mixed_units):
        raise AssertionError(f"phase 22: units {units}, expected K = 2 at "
                             "the default chunk bytes (vw, 2d6), batches of "
                             "more than 2 at 1e9, the PQ image alone")
    # 22c: ms an image, in turns
    order = ["raw", "per-image vw", "K-batch vw", "K-batch vw, chunk 1e9"]
    turns = {what: [] for what in order}
    for what in order + order[::-1]:
        turns[what].append(kb_run(what, k_imgs, kb_env[what], singles,
                                  batches(what), time_it=True) / len(k_imgs))
    for what in order:
        log(f"phase 22c {what} (units {units[what]}): "
            f"{' / '.join(f'{t:.2f}' for t in turns[what])} ms an image "
            f"(host clock, 8 4K images a call, in turns) | {card}")
    kb_stitch = kb_launches["stitch"]
    log(f"phase 22 the K-batch route: {kb_stitch} stitch "
        f"launches on its paths; {time.perf_counter() - t22:.1f} s | {card}")

    # ---- phase 23: reference interop on the card --------------------------
    # the 8 files of tests/goldens/ (written once by the reference library,
    # tools/make_reference_goldens.py: libjpeg-turbo's baseline streams, no
    # restart markers, ISO or XMP metadata) at their own 256x160: (a) each
    # file decoded on every route, held against the reference's own raster
    # and the port's CPU decode; (b) each golden's raw input encoded on the
    # card at the golden's configuration, its decode held against the
    # reference's; (c) the effects golden's 9 queues, through the host editor
    # and on the device.  Every apply and pack launch of the phase is
    # recorded with its inputs and held against its plain version; every
    # scan the phase builds is, as everywhere, at each read_counts.
    t23 = time.perf_counter()
    applied, packed = [], []
    real_apply_gainmap = ak.apply_gainmap
    real_pack_launch = pk.PACK_KERNEL.launch

    def recording_apply(sdr_yuv, gain, meta_rows, weight, **kw):
        out = real_apply_gainmap(sdr_yuv, gain, meta_rows, weight, **kw)
        if sdr_yuv.device.type == dev.type:
            applied.append((sdr_yuv.clone(), gain.clone(),
                            np.array(meta_rows, np.float32), weight, kw,
                            out.clone()))
        return out

    def recording_pack_launch(stream, dc_diff, is_luma, scratch, blen,
                              words):
        real_pack_launch(stream, dc_diff, is_luma, scratch, blen, words)
        packed.append((stream.clone(), dc_diff.clone(), is_luma.clone(),
                       scratch.clone(), blen.clone(), words.clone()))

    ak.apply_gainmap = recording_apply
    pk.PACK_KERNEL.launch = recording_pack_launch
    p23_launches = {}

    def start23():
        """Before a phase-23 path: the launch counts zeroed, nothing
        recorded."""
        zero_counts()
        applied.clear()
        packed.clear()

    def read23(path: str, want: dict) -> str:
        """read_counts of a phase-23 path, then every apply and pack launch
        it made held against its plain version on the same inputs on the
        card (bit-identical outputs; the pack's live words and block
        lengths torch.equal)."""
        got = read_counts(f"phase 23 {path}", want)
        add(p23_launches, got)
        torch.cuda.synchronize()
        if (len(applied), len(packed)) != (got["apply_gainmap"],
                                           got["pack_scan"]):
            raise AssertionError(
                f"phase 23 {path}: {len(applied)} apply and {len(packed)} "
                f"pack launches recorded, {got['apply_gainmap']} and "
                f"{got['pack_scan']} counted")
        for i, (sdr_yuv, gain, rows, weight, kw, out) in enumerate(applied):
            bit_identical(out, ak.apply_gainmap_plain(sdr_yuv, gain, rows,
                                                      weight, **kw),
                          f"phase 23 {path}: apply launch {i} vs plain")
        for i, (stream, dc_diff, is_luma, scratch, blen, words) in \
                enumerate(packed):
            pw, pb = pk.pack_scan_plain(stream, dc_diff, is_luma)
            tensors_equal((words[:int(scratch[1])], blen), (pw, pb),
                          f"phase 23 {path}: pack launch {i} vs plain")
        n = f"{len(applied)} apply and {len(packed)} pack launches"
        applied.clear()
        packed.clear()
        return n

    fmt23 = {**fmt_of, CT.SRGB: Fmt.RGBA8888}
    # transfer -> the goldens' raster of it and its PSNR
    raster23 = {CT.HLG: ("dec_hlg_1010102", testing.psnr),
                CT.PQ: ("dec_pq_1010102", testing.psnr),
                CT.LINEAR: ("dec_linear_f16", testing.psnr),
                CT.SRGB: ("dec_srgb_8888", testing.psnr_8888)}
    hdr23 = (CT.HLG, CT.PQ, CT.LINEAR)
    names23 = testing.golden_names()
    goldens = {n: testing.load_golden(n) for n in names23}
    files23 = {n: bytes(z["jpegr"]) for n, (z, _) in goldens.items()}
    # the effects golden holds the bytes of one of the others, whose
    # rasters it has not: it is decoded against that one's
    fx_z, _ = testing.load_golden(testing.EFFECTS_GOLDEN)
    twin = [n for n in names23 if files23[n] == bytes(fx_z["jpegr"])]
    if len(twin) != 1:
        raise AssertionError(f"phase 23: the effects golden's bytes are "
                             f"those of {twin}, not of one golden")
    files23[testing.EFFECTS_GOLDEN] = bytes(fx_z["jpegr"])
    raster_of = {n: goldens[n][0] for n in names23}
    raster_of[testing.EFFECTS_GOLDEN] = goldens[twin[0]][0]
    cpu23 = port.JpegR(device="cpu")
    jr23 = port.JpegR(device="cuda")
    on_cpu = {(n, ct): np.asarray(cpu23.decode(d, ct)[0].planes[0])
              for n, d in files23.items() for ct in raster23}
    psnr23 = {}

    def gate23(gname, route, ct, got, gate=testing.DECODE_GATE_DB):
        """A decode of file `gname` on `route` against the reference's
        raster (>= `gate`) and the port's CPU decode of the same bytes
        (SRGB equal, the HDR outputs within check_decoded_close; the host
        engine the JAX package's host-vs-device gate, >= 55 dB a channel,
        against the card's decode); returns its PSNR."""
        got = testing.host_packed(got) if ct != CT.SRGB \
            else np.asarray(got, np.uint32)
        key, psnr = raster23[ct]
        db = psnr(got, raster_of[gname][key])
        if not db >= gate:
            raise AssertionError(f"phase 23 {gname} {route} {ct.name}: "
                                 f"{db:.2f} dB against the reference's "
                                 f"raster, gate {gate}")
        want = on_cpu[gname, ct]
        if ct == CT.SRGB:
            if not np.array_equal(got, want):
                raise AssertionError(f"phase 23 {gname} {route} SRGB != the "
                                     "CPU decode")
        elif route == "decode_host":
            db_c = channel_psnr(got, psnr23[gname, "UhdrDecoder", ct][1])
            if min(db_c) < 55.0:
                raise AssertionError(f"phase 23 {gname} decode_host "
                                     f"{ct.name}: {db_c} dB a channel "
                                     "against the card's decode")
        else:
            testing.check_decoded_close(got, want, ct,
                                        f"phase 23 {gname} {route} {ct.name}")
        psnr23[gname, route, ct] = (db, got)
        return db

    # (a) every route of the decode
    taken = {r: f"fused, within check_decoded_close of the CPU's{t}"
             for r, t in (
                 ("UhdrDecoder", " (SRGB equal)"),
                 ("decode_to_device microbatched", ", == UhdrDecoder"),
                 ("decode_to_device per-image", ", == UhdrDecoder"))}
    taken["decode_host"] = ("the host engine, >= 55 dB a channel against the "
                            "card's UhdrDecoder decode")
    taken["general path"] = ("general (use_fused=False), within "
                             "check_decoded_close of the CPU's fused decode")
    for gname, data in files23.items():
        plan = jpegr._plan_of(jr23._parse_jpegr(data))
        if plan is None:
            raise AssertionError(f"phase 23 {gname}: the fused route does "
                                 "not take the reference's file")
        for route in ("UhdrDecoder", "decode_to_device microbatched",
                      "decode_to_device per-image", "decode_host",
                      "general path"):
            start23()
            jr_r = port.JpegR(device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs23 = {}
            for ct in (raster23 if route == "UhdrDecoder" else hdr23):
                if route == "UhdrDecoder":
                    dec = port.UhdrDecoder(device="cuda")
                    dec.set_image(data)
                    dec.set_out_color_transfer(ct)
                    dec.set_out_img_format(fmt23[ct])
                    outs23[ct] = dec.decode().planes[0]
                elif route == "decode_host":
                    outs23[ct] = jr_r.decode_host(data, ct)[0].planes[0]
                elif route == "general path":
                    outs23[ct] = jr_r.decode(data, ct,
                                             use_fused=False)[0].planes[0]
                else:
                    outs23[ct] = jr_r.decode_to_device(
                        data, ct, microbatch="micro" in route)[0]
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            if "micro" in route and jr_r._mb.retries:
                raise AssertionError(f"phase 23 {gname}: the microbatcher "
                                     "retried a request alone")
            n_apply = 0 if route == "decode_host" else 3
            # the fused routes decode both DRI-less scans on the card, once
            # an HDR output; the host engine and the general path do not
            fused_route = route not in ("decode_host", "general path")
            checked = read23(f"{gname} {route}", {
                "apply_gainmap": n_apply,
                "apply_linear": n_apply // 3,
                "huffman": 2 * len(hdr23) * fused_route})
            dbs = {ct: gate23(gname, route, ct, out)
                   for ct, out in outs23.items()}
            if route.startswith("decode_to_device"):
                for ct in hdr23:
                    bit_identical(outs23[ct],
                                  psnr23[gname, "UhdrDecoder", ct][1],
                                  f"phase 23 {gname} {route} {ct.name} vs "
                                  "UhdrDecoder")
            log(f"phase 23a {gname} {route}: "
                + ", ".join(f"{ct.name} {db:.2f} dB" for ct, db in dbs.items())
                + f" against the reference's raster; route {taken[route]}, "
                f"{checked}; {s:.3f} s | {card}")

    # one decode_to_device_batch over the 8 files (mixed configurations)
    for ct in hdr23:
        start23()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_b = port.JpegR(device="cuda").decode_to_device_batch(
            list(files23.values()), ct)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        # no other golden shares the first one's fused-route signature, so
        # no batch group forms: each file takes the per-image route, whose
        # entropy decodes of both DRI-less scans run on the card
        checked = read23(f"decode_to_device_batch {ct.name}",
                         {"apply_gainmap": len(files23),
                          "apply_linear": len(files23) * (ct == CT.LINEAR),
                          "huffman": 2 * len(files23)})
        dbs = []
        for gname, (got, _) in zip(files23, outs_b):
            dbs.append(gate23(gname, "decode_to_device_batch", ct, got))
            bit_identical(got, psnr23[gname, "UhdrDecoder", ct][1],
                          f"phase 23 batch {gname} {ct.name} vs UhdrDecoder")
        log(f"phase 23a decode_to_device_batch {ct.name} of the "
            f"{len(files23)} files: {min(dbs):.2f}-{max(dbs):.2f} dB against "
            f"the reference's rasters, every output == UhdrDecoder's and the "
            f"CPU decode's contract, {checked}; {s:.3f} s | {card}")

    def same_where_coefficients_agree(gname, data, cpu_data) -> str:
        """The card's file against the CPU's encode of the same input:
        equal byte for byte, or each JPEG's scan equal where its
        coefficients are; where a pixel
        stage's ulp moved a u8 sample by one (the card-vs-CPU encode
        contract, at most 1e-3 of the samples), a coefficient moves by at
        most 1, in at most 64 blocks of each 1,000 samples' worth."""
        if data == cpu_data:
            return "== the CPU encode byte for byte"
        moved = []
        for part, (a, b) in enumerate(zip(
                port.JpegR.extract_primary_and_gainmap(data),
                port.JpegR.extract_primary_and_gainmap(cpu_data))):
            ca = fused.decode_coefficients(a, jpeg_decoder.parse_jpeg(a))[0]
            cb = fused.decode_coefficients(b, jpeg_decoder.parse_jpeg(b))[0]
            diff = [np.abs(x.astype(np.int32) - y.astype(np.int32))
                    for x, y in zip(ca, cb)]
            if len(ca) != len(cb) or any(
                    x.shape != y.shape for x, y in zip(ca, cb)):
                raise AssertionError(f"phase 23 {gname} part {part}: other "
                                     "planes than the CPU encode's")
            if not any(d.any() for d in diff):
                # (the headers may differ: the base's MPF holds the sizes)
                if testing.scan_data(a) != testing.scan_data(b):
                    raise AssertionError(f"phase 23 {gname} part {part}: the "
                                         "CPU encode's coefficients, another "
                                         "scan")
                continue
            blocks = sum(int(d.reshape(-1, 64).any(1).sum()) for d in diff)
            n_blocks = sum(d.size // 64 for d in diff)
            top = max(int(d.max()) for d in diff)
            if top > 1 or blocks > 64e-3 * n_blocks:
                raise AssertionError(f"phase 23 {gname} part {part}: {blocks}"
                                     f" of {n_blocks} blocks differ from the "
                                     f"CPU encode's, by up to {top}")
            moved.append(f"part {part} {blocks} of {n_blocks} blocks within "
                         "1 of the CPU encode's")
        return "; ".join(moved) or "== the CPU encode"

    # (b) the goldens' raw inputs encoded on the card at their config
    enc23 = {}
    for gname in names23:
        z, cfg = goldens[gname]
        start23()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with testing.golden_metadata(cfg):
            data = testing.golden_encoder(z, cfg, "cuda").encode()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        checked = read23(f"{gname} encode", {"pack_scan": 1})
        with testing.golden_metadata(cfg):
            cpu_data = testing.golden_encoder(z, cfg, "cpu").encode()
        moved = same_where_coefficients_agree(gname, data, cpu_data)
        start23()
        dec = port.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_color_transfer(CT.HLG)
        dec.set_out_img_format(Fmt.RGBA1010102)
        ours = testing.host_packed(dec.decode().planes[0])
        read23(f"{gname} encode's decode", {"apply_gainmap": 1})
        cross = testing.psnr(ours, z["dec_hlg_1010102"])
        anchor = psnr23[gname, "UhdrDecoder", CT.HLG][0]
        if not (cross >= testing.ENCODE_GATE_DB
                and cross >= min(anchor, testing.ANCHOR_CAP_DB)
                - testing.ENCODE_SLACK_DB):
            raise AssertionError(f"phase 23 {gname}: card encode {cross:.2f}"
                                 f" dB against the reference's decode, "
                                 f"anchor {anchor:.2f} dB")
        enc23[gname] = (cross, s)
        log(f"phase 23b {gname} ({cfg['metadata']}, q{cfg['quality']}, scale "
            f"{cfg['scale']}, map q{cfg['map_quality']}, "
            f"{'3-channel' if cfg['multi'] else '1-channel'}, gamma "
            f"{cfg['gamma']}, preset {cfg['preset']}): card encode {s:.3f} s"
            f", {len(data)} bytes (reference {len(files23[gname])}), its "
            f"decode {cross:.2f} dB against the reference's (anchor "
            f"{anchor:.2f} dB), {checked}, scans == plain; {moved} | {card}")

    # (c) the effects golden's queues: the host editor behind UhdrDecoder,
    # and decode_to_device(effects=...)
    fx_dbs = []
    for fx_name, queue in testing.golden_effects():
        spec = [(kind, *args) for kind, args in queue]
        resize = "resize" in fx_name
        start23()
        for ct in (CT.SRGB, CT.HLG):
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(files23[testing.EFFECTS_GOLDEN])
            dec.set_out_color_transfer(ct)
            dec.set_out_img_format(fmt23[ct])
            testing.queue_effects(dec, queue)
            got = np.asarray(dec.decode().planes[0])
            ref = fx_z[f"{fx_name}_{'srgb' if ct == CT.SRGB else 'hlg'}"]
            if got.shape != ref.shape:
                raise AssertionError(f"phase 23 effect {fx_name} {ct.name}:"
                                     f" {got.shape} vs {ref.shape}")
            if ct == CT.SRGB:
                db = testing.psnr_8888(got, ref)
                if not (db >= testing.RESIZE_GATE_DB if resize
                        else np.array_equal(got, ref)):
                    raise AssertionError(f"phase 23 effect {fx_name} SRGB: "
                                         f"{db:.2f} dB, not the reference's")
            else:
                db = testing.psnr(got, ref)
            fx_dbs.append(db)
        dev_fx = port.JpegR(device="cuda").decode_to_device(
            files23[testing.EFFECTS_GOLDEN], CT.HLG,
            effects=effects_of(spec))[0]
        dev_db = testing.psnr(testing.host_packed(dev_fx),
                                      fx_z[f"{fx_name}_hlg"])
        # UhdrDecoder's HLG decode and decode_to_device's, two scans each
        checked = read23(f"effect {fx_name}", {"apply_gainmap": 2,
                                               "huffman": 4})
        gate = testing.RESIZE_GATE_DB if resize else testing.DECODE_GATE_DB
        if not (db >= gate and dev_db >= gate):
            raise AssertionError(f"phase 23 effect {fx_name} HLG: host "
                                 f"editor {db:.2f} dB, device {dev_db:.2f} "
                                 f"dB, gate {gate}")
        log(f"phase 23c effect {fx_name}: SRGB "
            f"{'%.2f dB' % fx_dbs[-2] if resize else '== the reference'}, "
            f"HLG host editor {db:.2f} dB, decode_to_device(effects=) "
            f"{dev_db:.2f} dB against the reference's rasters (gate {gate}),"
            f" {checked} | {card}")
    ak.apply_gainmap = real_apply_gainmap
    del pk.PACK_KERNEL.launch
    worst = {route: min(db for (n, r, ct), (db, _) in psnr23.items()
                        if r == route)
             for route in {r for _, r, _ in psnr23}}
    log(f"phase 23 reference interop: {len(files23)} reference files on "
        f"{len(worst)} decode routes, worst PSNR a route "
        + ", ".join(f"{r} {db:.2f}" for r, db in sorted(worst.items()))
        + f" dB; {len(enc23)} card encodes "
        f"{min(c for c, _ in enc23.values()):.2f}-"
        f"{max(c for c, _ in enc23.values()):.2f} dB; "
        f"{len(testing.golden_effects())} effect queues; launches "
        f"{p23_launches}; {time.perf_counter() - t23:.1f} s | {card}")

    # ---- phase 24: the entropy decode on the card ---------------------------
    p24 = huffman_phase(card)

    # ---- phase 25: the restart-row join on the card -------------------------
    p25 = join_phase(card)

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith(("jax.", "libultrahdr_tpu."))
              or m == "libultrahdr_tpu"]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")

    # ---- phase 11: records ------------------------------------------------
    src, tpu = "libultrahdr_tpu_torch/csrc/", "libultrahdr_tpu/"

    def record(kname, source, replaces, launches, row, err):
        return {"name": kname, "route": "cuda", "source": src + source,
                "replaces": tpu + replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "kernel_ms": row.get("kernel_ms"),
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}

    slice9 = (fx_dec_launches, fx_dev_launches, agtm_launches,
              public_launches)
    linear = apply_launches["apply_linear"] \
        + batch_launches[CT.LINEAR]["apply_linear"] \
        + general_launches["apply_linear"] + host_launches["apply_linear"] \
        + sum(c["apply_linear"] for c in slice9) + sharded_linear_launches \
        + wire_dec_launches["apply_linear"] + capi_total["apply_linear"] \
        + fuzz_launches["apply_linear"] + redecode_launches["apply_linear"] \
        + tools_launches["apply_linear"] + p23_launches["apply_linear"]
    hlg_pq = apply_launches["apply_gainmap"] + mb_launches["apply_gainmap"] \
        + sum(c["apply_gainmap"] for c in batch_launches.values()) \
        + general_launches["apply_gainmap"] \
        + host_launches["apply_gainmap"] \
        + sum(c["apply_gainmap"] for c in slice9) \
        + sharded_apply_launches + wire_dec_launches["apply_gainmap"] \
        + capi_total["apply_gainmap"] + fuzz_launches["apply_gainmap"] \
        + redecode_launches["apply_gainmap"] \
        + tools_launches["apply_gainmap"] + p23_launches["apply_gainmap"] \
        - linear
    later = (wire_dec_launches, capi_total, fuzz_launches, redecode_launches,
             tools_launches, p23_launches)
    log(f"launches of phases 3-17, no wire knob set: pack_scan "
        f"{before_wires['pack_scan']}, apply HLG/PQ "
        f"{hlg_pq - sum(c['apply_gainmap'] - c['apply_linear'] for c in later)}"
        f", apply LINEAR {linear - sum(c['apply_linear'] for c in later)}, "
        f"scan kernel {before_wires['forward_dct']}; phase 18 added pack_scan "
        f"{wire_enc_launches['pack_scan']}, apply "
        f"{wire_dec_launches['apply_gainmap']} (LINEAR "
        f"{wire_dec_launches['apply_linear']}), scan kernel "
        f"{wire_enc_launches['forward_dct']}; phase 19 (the C ABI) added "
        f"pack_scan {capi_total['pack_scan']}, apply "
        f"{capi_total['apply_gainmap']} (LINEAR {capi_total['apply_linear']})"
        f", scan kernel {capi_total['forward_dct']}; phase 20 (the card "
        f"fuzz and the decodes after it) added apply "
        f"{sum(c['apply_gainmap'] for c in later[2:4])} (LINEAR "
        f"{sum(c['apply_linear'] for c in later[2:4])}); phase 21 (the "
        f"benchmark tools' rows) added pack_scan "
        f"{tools_launches['pack_scan']}, apply "
        f"{tools_launches['apply_gainmap']} (LINEAR "
        f"{tools_launches['apply_linear']}), scan kernel "
        f"{tools_launches['forward_dct']}; phase 22 (the K-batch route) "
        f"added pack_scan {kb_launches['pack_scan']}, scan kernel "
        f"{kb_launches['forward_dct']}, un-slice "
        f"{kb_launches['wire_unslice']}, stitch {kb_launches['stitch']}; "
        f"phase 23 (reference interop) added pack_scan "
        f"{p23_launches['pack_scan']}, apply "
        f"{p23_launches['apply_gainmap']} (LINEAR "
        f"{p23_launches['apply_linear']}), scan kernel "
        f"{p23_launches['forward_dct']}, entropy decode "
        f"{p23_launches['huffman']}; phase 24 (the entropy decode) "
        f"{p24['launches']}, {p24['path_launches']} of them through "
        f"UhdrDecoder.decode")
    log(json.dumps({"kernels": [
        record("pack_scan", "pack_kernel.cu", "jpeg/pack_kernel.py:595",
               p010_launches["pack_scan"] + rgb_launches["pack_scan"]
               + fold_launches["pack_scan"] + api1_launches["pack_scan"]
               + compressed_launches["pack_scan"] + pipe_launches
               + general_input_launches["pack_scan"]
               + fx_enc_launches["pack_scan"] + public_launches["pack_scan"]
               + sharded_pack_launches + wire_enc_launches["pack_scan"]
               + capi_total["pack_scan"] + tools_launches["pack_scan"]
               + kb_launches["pack_scan"] + p23_launches["pack_scan"],
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
               hlg_pq, apply_rows["default", CT.HLG], apply_err),
        record("apply_gainmap_linear", "apply_kernel.cu",
               "ops/pallas_apply.py:164", linear,
               apply_rows["default", CT.LINEAR], apply_err),
        # the JAX package builds a scan with XLA ops (its forward DCT a
        # matrix product), no pallas_call: the scan kernel gives every
        # plane size the same rounding (jpeg/dct.py)
        record("forward_dct", "dct_kernel.cu",
               "fused.py:62 (_scan_coeffs, jpeg/dct.py:151 forward_plane; "
               "jpeg/pack_kernel.py:559 _stream_inputs)",
               dct_launches[0], dct_rows["default"],
               max(r["err"] for r in dct_rows.values())),
        # the JAX package un-slices its upload wires and packs its download
        # wire with XLA ops, no pallas_call (fused.py)
        record("wire_unslice", "wire_kernel.cu",
               "fused.py:299 (_vw_unslice; fused.py:126 _delta_decode_plane,"
               " fused.py:1835 _unpack_one_n)",
               wire_enc_launches["wire_unslice"]
               + wire_dec_launches["wire_unslice"]
               + kb_launches["wire_unslice"], unslice_row, 0),
        record("down_pack", "wire_kernel.cu",
               "fused.py:2022 (_down_delta_sections; fused.py:2053 / :2123 "
               "_pack_down_wire_1010102 / _f16)",
               wire_dec_launches["down_pack"], down_row, 0),
        # the JAX package stitches a K-batch with XLA ops, no pallas_call
        record("stitch", "stitch_kernel.cu",
               "fused.py:2608 (_stitch_image_streams)", kb_stitch,
               stitch_rows["K = 8"], 0),
        # the JAX package Huffman-decodes on the host, no pallas_call
        # (jpeg/native.py:565 decode_scan); the row is the HLG base's
        record("huffman", "huffman_kernel.cu",
               "jpeg/native.py:565 (decode_scan, host C++)",
               p23_launches["huffman"] + p24["path_launches"], p24["row"],
               0),
        # the JAX package joins a scan's rows on the host, no pallas_call
        # (jpeg/native.py:501 join_blocks); the row is the 8K encode's
        record("join", "join_kernel.cu",
               "jpeg/native.py:501 (join_blocks, host C++)",
               join_launches[0] + tools_launches["join"]
               + p25["path_launches"], p25["row"], 0)]}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from phase 1 "
        "to the records")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
