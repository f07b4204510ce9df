#!/usr/bin/env python3
"""Throughput of the port's multi-image routes on one NVIDIA GPU.

    python3 profile_throughput.py [--out DIR] [--reps N]

The inputs are ``testing.photo_p010(3840, 2160)`` at 16 seeds (P010, BT2100
HLG, quality 95), in both configurations (benchmark: map scale 4, 1-channel
map; default: scale 1, 3-channel map).  In turns, REPS times each (medians):

1. encode: a loop of ``UhdrEncoder(device="cuda")`` requests over images
   0-7, one at a time, then ``fused.encode_api0_p010_pipelined`` over images
   0-7 and over 0-15 (host clock, a synchronize on each side); every
   pipelined file must equal the loop's file of its image;
2. decode: the pipelined files of images 0-7 to HLG and to LINEAR, eight
   ``decode_to_device(..., microbatch=False)`` calls one after another, then
   one ``decode_to_device_batch`` of the eight, then eight concurrent
   ``decode_to_device`` callers on eight threads (the microbatcher at its
   defaults: 4 ms window, batches of up to 8; its batch dispatches and
   retries are recorded); outputs left on the card, a synchronize after;
3. SRGB: one ``UhdrDecoder`` RGBA8888 decode per configuration.

It also records, for one pipelined call of 8 and one batch decode of 8, the
device's busy share (the union of kernel and copy intervals of a
``torch.profiler`` trace over the wall time) and the same for the loops of
single requests, and, for one more pipelined call of 8 (not traced), how
long each image's dispatch and container held the caller's thread and each
join a pool thread (the functions wrapped here with a host clock; nothing
in the package is changed), and the same for a call at depth 1, where the
stages take turns and nothing runs beside them.

4. host: what the pipeline's host threads do to one another (default
   configuration).  Eight joins of downloaded scans on 1, 2, 4 and 8
   threads; the dispatch of one image (``fused._dispatch_p010``, host ms,
   median of 8) on a slot's own stream, on a fresh stream, and beside four
   threads that join scans, that wait in ``Event.synchronize()`` on a
   default (spinning) event and on a blocking one; the pinned staging of a
   4K Y plane by ``Tensor.pin_memory()`` and by ``pixel.pinned``, alone and
   beside four joining threads.

Prints a line per measurement with the card's name and power limit
(nvidia-smi) and writes DIR/throughput_profile.json.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import libultrahdr_tpu_torch as port  # noqa: E402
from libultrahdr_tpu_torch import fused, testing  # noqa: E402
from libultrahdr_tpu_torch.ops import pixel  # noqa: E402

W, H = 3840, 2160
CONFIGS = {"benchmark": (4, False), "default": (1, True)}
CT = port.ColorTransfer


def timed(fn):
    """(fn(), host ms) with a synchronize on each side."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def busy_share(fn) -> float:
    """The share of the wall time of one fn() in which the device ran a
    kernel or a copy, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / wall_us


def encode_one(img, scale: int, multichannel: bool) -> bytes:
    enc = port.UhdrEncoder(device="cuda")
    enc.set_raw_image(img, port.ImgLabel.HDR)
    enc.set_quality(95, port.ImgLabel.BASE)
    enc.set_gainmap_scale_factor(scale)
    enc.set_using_multi_channel_gainmap(multichannel)
    return enc.encode()


def host_contention(jr, imgs, card) -> dict:
    """Section 4 of the docstring, on jr's configuration."""
    dev = jr.device
    fused.encode_api0_p010_pipelined(jr, imgs[:8])     # slots and streams
    slot = fused._SLOTS[dev][0]
    jobs = []
    for img in imgs[:8]:
        job = fused._dispatch_p010(jr, img, 95, slot)
        job.event.synchronize()
        words = slot.download(job.words, int(slot.total_h[0])).copy()
        jobs.append((words, job.blen.numpy().copy(), job.layouts))
    out = {"joins_8_ms": {}}
    for n in (1, 2, 4, 8):
        with concurrent.futures.ThreadPoolExecutor(n) as p:
            _, ms = timed(lambda: list(p.map(
                lambda j: fused._join_scans(*j), jobs)))
        out["joins_8_ms"][n] = ms
    stop = threading.Event()

    def joiner(k):
        while not stop.is_set():
            fused._join_scans(*jobs[k])

    def waiter(blocking):
        def wait(_):
            s = torch.cuda.Stream(dev)
            while not stop.is_set():
                with torch.cuda.stream(s):
                    torch.cuda._sleep(int(5e7))
                    ev = torch.cuda.Event(blocking=blocking)
                    ev.record(s)
                ev.synchronize()
        return wait

    def dispatch_ms(fresh=False) -> float:
        ms = []
        for img in imgs[:8]:
            s = fused._Slot(dev, torch.cuda.Stream(dev)) if fresh else slot
            t0 = time.perf_counter()
            job = fused._dispatch_p010(jr, img, 95, s)
            ms.append((time.perf_counter() - t0) * 1e3)
            job.event.synchronize()
        return statistics.median(ms)

    def staging_ms(fn) -> float:
        y = imgs[0].planes[0].view("int16")
        ms = []
        for _ in range(8):
            t0 = time.perf_counter()
            fn(y)
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    out["dispatch_ms"] = {"alone": dispatch_ms(),
                          "fresh stream": dispatch_ms(fresh=True)}
    out["staging_ms"] = {
        "pin_memory alone": staging_ms(
            lambda a: torch.from_numpy(a).pin_memory()),
        "pixel.pinned alone": staging_ms(pixel.pinned)}
    for beside, fn in (("4 joining", joiner),
                       ("4 spinning waits", waiter(False)),
                       ("4 sleeping waits", waiter(True))):
        stop.clear()
        with concurrent.futures.ThreadPoolExecutor(4) as p:
            futs = [p.submit(fn, k) for k in range(4)]
            time.sleep(0.05)
            out["dispatch_ms"][f"beside {beside}"] = dispatch_ms()
            if beside == "4 joining":
                out["staging_ms"]["pin_memory beside 4 joining"] = \
                    staging_ms(lambda a: torch.from_numpy(a).pin_memory())
                out["staging_ms"]["pixel.pinned beside 4 joining"] = \
                    staging_ms(pixel.pinned)
            stop.set()
            for f in futs:
                f.result()
    torch.cuda.synchronize()
    for k, v in out.items():
        print(f"host {k}: " + ", ".join(f"{a} {b:.2f}" for a, b in v.items())
              + f" | {card}", flush=True)
    return out


class HeldTimes:
    """Host ms of each call of fused._dispatch_p010 and _container_p010
    (the caller's thread) and _join_p010 (a pool thread) while `on`."""

    def __init__(self):
        self.on = False
        self.ms = {"dispatch": [], "join": [], "container": []}
        self._lock = threading.Lock()
        for name in self.ms:
            fn = getattr(fused, f"_{name}_p010")
            setattr(fused, f"_{name}_p010", self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed_call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if self.on:
                    with self._lock:
                        self.ms[name].append(
                            (time.perf_counter() - t0) * 1e3)
        return timed_call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_throughput: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        imgs = list(pool.map(lambda s: testing.photo_p010(W, H, seed=s),
                             range(16)))
    held = HeldTimes()
    out = {"card": card, "reps": args.reps, "host_threads":
           fused.HOST_THREADS, "depth": fused.PIPELINE_DEPTH,
           "encode": {}, "decode": {}, "srgb": {}}
    mp = W * H / 1e6
    files = {}
    for cfg, (scale, mc) in CONFIGS.items():
        jr = port.JpegR(device="cuda", map_dimension_scale_factor=scale,
                        use_multi_channel_gainmap=mc)
        loop_want = [encode_one(im, scale, mc) for im in imgs[:16]]
        fused.encode_api0_p010_pipelined(jr, imgs[:8])      # warm-up
        runs = {"loop 8": [], "pipelined 8": [], "pipelined 16": []}
        for _ in range(args.reps):
            _, ms = timed(lambda: [encode_one(im, scale, mc)
                                   for im in imgs[:8]])
            runs["loop 8"].append(ms)
            for n in (8, 16):
                got, ms = timed(lambda: fused.encode_api0_p010_pipelined(
                    jr, imgs[:n]))
                if got != loop_want[:n]:
                    raise AssertionError(f"{cfg}: pipelined {n} != the "
                                         "single-image encodes")
                runs[f"pipelined {n}"].append(ms)
        files[cfg] = loop_want[:8]
        res = {}
        for key, ms in runs.items():
            n = int(key.split()[-1])
            med = statistics.median(ms)
            res[key] = {"median_ms": med, "all_ms": ms,
                        "ms_per_image": med / n,
                        "mp_per_s": n * mp / med * 1e3}
            print(f"encode {cfg} {key}: median {med:.1f} ms ({ms}), "
                  f"{med / n:.2f} ms an image, {n * mp / med * 1e3:.1f} MP/s "
                  f"| {card}", flush=True)
        res["busy_pipelined_8"] = busy_share(
            lambda: fused.encode_api0_p010_pipelined(jr, imgs[:8]))
        res["busy_loop_8"] = busy_share(
            lambda: [encode_one(im, scale, mc) for im in imgs[:8]])
        print(f"encode {cfg}: device busy {res['busy_pipelined_8']:.1%} of a "
              f"pipelined call of 8 (loop of 8: {res['busy_loop_8']:.1%}) "
              f"| {card}", flush=True)
        for depth in (fused.PIPELINE_DEPTH, 1):
            saved, fused.PIPELINE_DEPTH = fused.PIPELINE_DEPTH, depth
            held.on = True
            _, ms = timed(lambda: fused.encode_api0_p010_pipelined(
                jr, imgs[:8]))
            held.on = False
            fused.PIPELINE_DEPTH = saved
            res[f"held_ms_depth_{depth}"] = dict(
                held.ms, call_ms=ms)
            held.ms = {k: [] for k in held.ms}
            print(f"encode {cfg} depth {depth}: {ms:.1f} ms for 8; "
                  + "; ".join(f"{k} ms an image "
                              f"{[round(x, 2) for x in v]}"
                              for k, v in res[f"held_ms_depth_{depth}"]
                              .items() if k != "call_ms")
                  + f" | {card}", flush=True)
        out["encode"][cfg] = res

    for cfg in CONFIGS:
        for ct in (CT.HLG, CT.LINEAR):
            jr = port.JpegR(device="cuda")
            streams = files[cfg]
            jr.decode_to_device_batch(streams[:2], ct)              # warm-up
            runs = {"one at a time 8": [], "batch 8": [],
                    "8 concurrent callers": []}
            dispatches = []
            for _ in range(args.reps):
                _, ms = timed(lambda: [jr.decode_to_device(
                    d, ct, microbatch=False) for d in streams])
                runs["one at a time 8"].append(ms)
                _, ms = timed(lambda: jr.decode_to_device_batch(streams, ct))
                runs["batch 8"].append(ms)
                jr_c = port.JpegR(device="cuda")
                meet = threading.Barrier(len(streams))

                def caller(d):
                    meet.wait()
                    return jr_c.decode_to_device(d, ct)
                with concurrent.futures.ThreadPoolExecutor(len(streams)) as p:
                    _, ms = timed(lambda: list(p.map(caller, streams)))
                runs["8 concurrent callers"].append(ms)
                mb = jr_c._decode_microbatcher()
                dispatches.append((mb.batches, mb.retries))
            res = {"microbatcher_batches_retries": dispatches}
            for key, ms in runs.items():
                med = statistics.median(ms)
                res[key] = {"median_ms": med, "all_ms": ms,
                            "ms_per_image": med / 8,
                            "mp_per_s": 8 * mp / med * 1e3}
                print(f"decode {cfg} {ct.name} {key}: median {med:.1f} ms "
                      f"({ms}), {med / 8:.2f} ms an image, "
                      f"{8 * mp / med * 1e3:.1f} MP/s | {card}", flush=True)
            res["busy_batch_8"] = busy_share(
                lambda: jr.decode_to_device_batch(streams, ct))
            res["busy_one_at_a_time_8"] = busy_share(
                lambda: [jr.decode_to_device(d, ct, microbatch=False)
                         for d in streams])
            print(f"decode {cfg} {ct.name}: microbatcher (batches, retries) "
                  f"per rep {dispatches}; device busy "
                  f"{res['busy_batch_8']:.1%} of a batch of 8, "
                  f"{res['busy_one_at_a_time_8']:.1%} of 8 one at a time "
                  f"| {card}", flush=True)
            out["decode"][f"{cfg} {ct.name}"] = res

    for cfg in CONFIGS:
        def srgb():
            dec = port.UhdrDecoder(device="cuda")
            dec.set_image(files[cfg][0])
            dec.set_out_color_transfer(CT.SRGB)
            dec.set_out_img_format(port.ImgFmt.RGBA8888)
            return dec.decode()
        srgb()                                                      # warm-up
        ms = [timed(srgb)[1] for _ in range(args.reps)]
        med = statistics.median(ms)
        out["srgb"][cfg] = {"median_ms": med, "all_ms": ms}
        print(f"SRGB decode {cfg}: median {med:.1f} ms ({ms}), "
              f"{mp / med * 1e3:.1f} MP/s | {card}", flush=True)

    scale, mc = CONFIGS["default"]
    out["host"] = host_contention(
        port.JpegR(device="cuda", map_dimension_scale_factor=scale,
                   use_multi_channel_gainmap=mc), imgs, card)

    path = pathlib.Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "throughput_profile.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
