#!/usr/bin/env python3
"""Stage profile of the port's 4K API-1 encode on one NVIDIA GPU.

    python3 profile_encode.py [--out DIR]

The input is chip_smoke's: ``testing.photo_p010(3840, 2160)`` (P010, BT2100
HLG) as the HDR intent and ``JpegR(device="cuda").tone_map`` of it as the
SDR intent (YUV420, Display-P3), quality 95, in both configurations
(benchmark: map scale 4, 1-channel map; default: scale 1, 3-channel map)
and both presets (REALTIME: the one-pass map; BEST_QUALITY: the two-pass
map).  For each it measures:

1. requests: ``UhdrEncoder(device="cuda").encode()``, host clock with a
   synchronize on each side, median and quartiles of REPS requests after 2
   warm-ups;
2. stages: the steps of ``fused.encode_api1_fused`` run one by one with a
   synchronize and a host clock at each boundary (upload of the five
   planes, unpack and the base's YUV re-encoding, the base's MCU pad and
   DCT, the gain map or its float pass, the read of the bounds, the map's
   quantisation and DCT, stream glue, pack kernel, download, host join,
   headers and container), median of REPS after 2 warm-ups; the staged
   request's bytes must equal the request's;
3. busy share: the union of the device's kernel and copy intervals in a
   ``torch.profiler`` trace of 3 requests over their wall time.

Prints a line per measurement with the card's name and power limit
(nvidia-smi) and writes DIR/encode_profile.json.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import libultrahdr_tpu_torch as port  # noqa: E402
from libultrahdr_tpu_torch import fused, testing  # noqa: E402
from libultrahdr_tpu_torch.jpeg import device_entropy  # noqa: E402
from libultrahdr_tpu_torch.jpeg import pack_kernel as pk  # noqa: E402
from libultrahdr_tpu_torch.ops import gainmap as gainmap_ops  # noqa: E402
from libultrahdr_tpu_torch.ops import pixel  # noqa: E402

W, H = 3840, 2160
REPS = 10
CONFIGS = {"benchmark": (4, False), "default": (1, True)}
PRESETS = {"REALTIME": port.EncPreset.REALTIME,
           "BEST_QUALITY": port.EncPreset.BEST_QUALITY}
CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt


def request(hdr, sdr, scale: int, multichannel: bool, preset) -> bytes:
    enc = port.UhdrEncoder(device="cuda")
    enc.set_raw_image(hdr, port.ImgLabel.HDR)
    enc.set_raw_image(sdr, port.ImgLabel.SDR)
    enc.set_quality(95, port.ImgLabel.BASE)
    enc.set_preset(preset)
    enc.set_gainmap_scale_factor(scale)
    enc.set_using_multi_channel_gainmap(multichannel)
    return enc.encode()


def timed_request(*args) -> tuple[bytes, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = request(*args)
    torch.cuda.synchronize()
    return data, (time.perf_counter() - t0) * 1e3


class StageClock:
    """A synchronize and a host clock at each stage boundary."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        torch.cuda.synchronize()
        self.t = time.perf_counter()

    def lap(self, stage: str):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + (now - self.t) * 1e3
        self.t = now


def staged(hdr, sdr, scale: int, multichannel: bool, preset):
    """fused.encode_api1_fused for P010 + YUV420, split at its stage
    boundaries: (bytes, {stage: ms}, bytes downloaded)."""
    jr = port.JpegR(device="cuda", map_dimension_scale_factor=scale,
                    use_multi_channel_gainmap=multichannel, preset=preset)
    clock = StageClock()
    y, uv, sy, su, sv = fused.upload_planes(
        [*fused._p010_planes(hdr), *sdr.planes[:3]], jr.device)
    clock.lap("upload (5 planes, raw)")
    hdr_vals = pixel.unpack_p010(y, uv, port.ColorRange(hdr.range), H, W)
    sdr_vals = pixel.unpack_yuv8(sy, su, sv, 2, 2, H, W)
    planes = fused._convert_yuv_encoding_planes(
        (sy, su, sv), Fmt.YUV420, CG(sdr.cg), CG.DISPLAY_P3, H, W)
    clock.lap("unpack + YUV re-encoding")
    base = fused._base_scan(list(planes), fused._SAMPLING_420, 95)
    clock.lap("base MCU pad + DCT")
    use_base_cg = fused._use_base_cg(CG(sdr.cg), CG(hdr.cg), jr.write_xmp)
    common = dict(sdr_fmt=Fmt.YUV420, hdr_fmt=Fmt.P010, sdr_cg=CG(sdr.cg),
                  hdr_cg=CG(hdr.cg), ct=CT(hdr.ct), scale=scale,
                  multichannel=multichannel, use_luminance=True,
                  sdr_is_601=False, use_base_cg=use_base_cg)
    if preset == port.EncPreset.REALTIME:
        gm = gainmap_ops.generate_gainmap_onepass(
            sdr_vals, hdr_vals, gamma=1.0, max_boost=1000.0 / 203.0,
            **common)
        clock.lap("gain map (one pass)")
        md = fused._onepass_metadata(jr, CT(hdr.ct), use_base_cg)
    else:
        gains, gmin, gmax = gainmap_ops.gainmap_float_pass(
            sdr_vals, hdr_vals, **common)
        clock.lap("gain map float pass + min/max")
        lo, hi = fused.api1_bounds(jr, gmin, gmax)
        clock.lap("bound read + resolution (host)")
        gm = gainmap_ops.encode_gainmap_twopass(gains, lo, hi, 1.0)
        clock.lap("map quantisation")
        md = fused._twopass_metadata(jr, CT(hdr.ct), lo, hi, use_base_cg)
    scans = [base, fused._gainmap_scan(gm, multichannel, 95)]
    clock.lap("map MCU pad + DCT")
    ins = [torch.cat(p) for p in zip(*(
        device_entropy.stream_inputs(c, lay) for c, lay in scans))]
    clock.lap("stream glue")
    words, blen = pk.pack_scan(*ins)
    clock.lap("pack kernel (wrapper)")
    words_h = words.cpu().numpy().view(np.uint32)
    blen_h = blen.cpu().numpy().astype(np.uint16)
    clock.lap("download (words + lengths)")
    (_, bl), (_, gl) = scans
    n_base = bl.mcus_h * bl.bpr
    base_scan, gm_scan = fused.fetch_blocks_multi(
        words_h, [(blen_h[:n_base], bl.bpr), (blen_h[n_base:], gl.bpr)])
    clock.lap("host join")
    data = fused._assemble_container(
        jr, W, H, 95, base_scan, fused._SAMPLING_420, CG(sdr.cg), scale,
        gm_scan, md, None, CT(hdr.ct), CG(hdr.cg))
    clock.lap("headers + container")
    return data, clock.ms, words_h.nbytes + blen_h.nbytes * 2


def busy_share(fn, n: int) -> float:
    """The share of the wall time in which the device ran a kernel or a
    copy, over n calls of fn, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / wall_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    hdr = testing.photo_p010(W, H)
    sdr = port.JpegR(device="cuda").tone_map(hdr)
    out = {"card": card, "reps": REPS, "requests": {}, "stages": {}}
    for (pname, preset), (cfg, (scale, mc)) in (
            (p, c) for p in PRESETS.items() for c in CONFIGS.items()):
        key = f"{pname} {cfg}"
        args_ = (hdr, sdr, scale, mc, preset)
        for _ in range(2):
            timed_request(*args_)
        runs = [timed_request(*args_) for _ in range(REPS)]
        ms = [m for _, m in runs]
        q1, med, q3 = statistics.quantiles(ms, n=4)
        out["requests"][key] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3,
                                "all_ms": ms}
        print(f"request {key}: median {med:.2f} ms (quartiles {q1:.2f}-"
              f"{q3:.2f}), {W * H / med / 1e3:.1f} MP/s | {card}",
              flush=True)
        for _ in range(2):
            staged(*args_)
        laps = []
        for _ in range(REPS):
            data, stage_ms, down = staged(*args_)
            laps.append(stage_ms)
        if data != runs[0][0]:
            raise AssertionError(f"{key}: the staged request's bytes differ "
                                 "from the request's")
        med_stages = {s: statistics.median(lap[s] for lap in laps)
                      for s in laps[0]}
        total = statistics.median(sum(lap.values()) for lap in laps)
        share = busy_share(lambda: request(*args_), 3)
        out["stages"][key] = {"median_ms": med_stages, "total_ms": total,
                              "download_bytes": down, "busy_share": share}
        print(f"stages {key} (median of {REPS}, ms; download {down} bytes; "
              f"device busy {share:.1%}): "
              + ", ".join(f"{s} {v:.2f}" for s, v in med_stages.items())
              + f", total {total:.2f} | {card}", flush=True)
    path = pathlib.Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "encode_profile.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
