#!/usr/bin/env python3
"""Stage profile of the port's 4K JPEG_R decode on one NVIDIA GPU.

    python3 profile_decode.py [--out DIR]
    python3 profile_decode.py --first-decode {encode,routes,routes+empty_cache}

Encodes ``testing.photo_p010(3840, 2160)`` with ``UhdrEncoder(device="cuda")``
in the two configurations of ``chip_smoke.py`` (benchmark: map scale 4,
1-channel map; default: scale 1, 3-channel map) and then measures:

1. requests: ``UhdrDecoder(device="cuda").decode()`` per file and output
   (HLG, PQ, LINEAR), host clock with a synchronize on each side, median and
   quartiles of REPS requests after 2 warm-ups;
2. stages: the steps of ``JpegR._decode_fused`` (after ``_parse_jpegr``)
   run one by one with a synchronize and a host clock at each boundary
   (split + parse + metadata, host Huffman decode, upload, base IDCT, map
   IDCT + YCbCr->RGB, IDW, apply kernel, download), median of REPS;
3. busy share: the union of the device's kernel and copy intervals in a
   ``torch.profiler`` trace of 3 HLG requests over their wall time;
4. cProfile of one request (host functions by own time);
5. the 3-channel gain map's interleave to (H, W, 3), on the host after the
   download against a device permute before it, alternated.

Prints a line per measurement with the card's name and power limit
(nvidia-smi) and writes DIR/decode_profile.json and the traces
DIR/decode_trace_<config>.json.

``--first-decode AFTER`` measures only the first decodes of the process,
each split at the stage boundaries as in 2.: the first benchmark HLG decode
after the encodes alone (``encode``), or after the block-pack and tile-pack
routes and their plain versions have packed both 4K files' scans
(``routes``, as chip_smoke ran them before its decode), or after those and
``torch.cuda.empty_cache()`` (``routes+empty_cache``); then three more
decodes.  It prints the caching allocator's reserved bytes beside each and
writes DIR/decode_first_<AFTER>.json.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pathlib
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import libultrahdr_tpu_torch as port  # noqa: E402
from libultrahdr_tpu_torch import fused, jpegr, testing  # noqa: E402
from libultrahdr_tpu_torch.jpeg.dct import inverse_plane  # noqa: E402
from libultrahdr_tpu_torch.jpeg import device_entropy  # noqa: E402
from libultrahdr_tpu_torch.jpeg import pack_kernel as pk  # noqa: E402
from libultrahdr_tpu_torch.jpeg.decoder import _ycc_to_rgb  # noqa: E402
from libultrahdr_tpu_torch.ops import apply as apply_ops  # noqa: E402
from libultrahdr_tpu_torch.ops import apply_kernel as ak  # noqa: E402
from libultrahdr_tpu_torch.ops import idw, pixel  # noqa: E402

W, H = 3840, 2160
REPS = 10
CONFIGS = {"benchmark": (4, False), "default": (1, True)}
OUTPUTS = {"HLG": (port.ColorTransfer.HLG, port.ImgFmt.RGBA1010102),
           "PQ": (port.ColorTransfer.PQ, port.ImgFmt.RGBA1010102),
           "LINEAR": (port.ColorTransfer.LINEAR, port.ImgFmt.RGBAF16)}


def request(data: bytes, out: str):
    ct, fmt = OUTPUTS[out]
    dec = port.UhdrDecoder(device="cuda")
    dec.set_image(data)
    dec.set_out_color_transfer(ct)
    dec.set_out_img_format(fmt)
    return dec.decode()


def timed_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def staged(data: bytes, out: str, dev: torch.device):
    """One decode split at its stage boundaries: ({stage: ms}, bytes
    downloaded, bytes uploaded)."""
    ct = OUTPUTS[out][0]
    ms = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    jr = port.JpegR(device=dev)
    primary, pinfo, gm_jpeg, gm_info, md, sdr_cg, gm_cg = \
        jr._parse_jpegr(data)
    mark("split + parse + metadata")
    bc, bq, _ = fused.decode_coefficients(primary, pinfo)
    gc, gq, _ = fused.decode_coefficients(gm_jpeg, gm_info)
    mark("host Huffman decode")
    ub = fused.upload_coeff_planes(bc, dev)
    ug = fused.upload_coeff_planes(gc, dev)
    mark("upload")
    planes = [inverse_plane(c, q, -(-H // (2 if i else 1)),
                            -(-W // (2 if i else 1)))
              for i, (c, q) in enumerate(zip(ub, bq))]
    sdr = pixel.unpack_yuv8(planes[0], planes[1], planes[2], 2, 2, H, W)
    mark("base IDCT + chroma")
    k = W // gm_info.width
    mh, mw = gm_info.height, gm_info.width
    gm = [inverse_plane(c, q, mh, mw) for c, q in zip(ug, gq)]
    gm_u8 = gm[0][None] if len(gm) == 1 \
        else _ycc_to_rgb(gm[0], gm[1], gm[2], "444", mh, mw)
    mark("map IDCT + ycc_to_rgb")
    gain = idw.idw_upsample(apply_ops._gain_to_float(gm_u8), k, H,
                            W).contiguous()
    mark("gain to float + IDW")
    weight = np.float32(apply_ops.gainmap_weight(
        jpegr.FLT_MAX, float(md.hdr_capacity_min),
        float(md.hdr_capacity_max)))
    packed = ak.apply_gainmap(
        sdr, gain, ak.meta_to_rows(apply_ops.metadata_to_arrays(md)), weight,
        out_ct=ct, sdr_cg=port.ColorGamut(sdr_cg),
        hdr_cg=port.ColorGamut(gm_cg), use_base_cg=bool(md.use_base_cg))
    mark("apply kernel")
    down = packed.cpu().numpy().nbytes \
        + gm_u8.permute(1, 2, 0).contiguous().cpu().numpy().nbytes
    mark("download")
    return ms, down, sum(x.numel() * x.element_size() for x in ub + ug)


def busy_share(trace_path: pathlib.Path):
    """(busy us, {category: count}, top kernels) of a chrome trace: the
    union of its kernel, memcpy and memset intervals."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    busy, cur = 0.0, None
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if cur is None or s > cur[1]:
            if cur:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur:
        busy += cur[1] - cur[0]
    counts, top = {}, {}
    for e in events:
        counts[e["cat"]] = counts.get(e["cat"], 0) + 1
        if e["cat"] == "kernel":
            top[e["name"][:60]] = top.get(e["name"][:60], 0) + e["dur"]
    return busy, counts, sorted(top.items(), key=lambda x: -x[1])[:8]


def route_load(img, dev: torch.device):
    """The block-pack and tile-pack routes and their plain versions on the
    4K P010 scans of both configurations, as chip_smoke's route phase runs
    them; returns what it keeps alive."""
    kept = []
    for scale, multichannel in CONFIGS.values():
        scans = fused._api0_p010_block_buffers(
            *fused.upload_p010(img, dev), cg=port.ColorGamut.BT2100,
            ct=port.ColorTransfer.HLG, rng=port.ColorRange.FULL, scale=scale,
            multichannel=multichannel, gamma=1.0, quality=95, map_quality=95,
            use_base_cg=False)
        pays, lens = testing.scans_slots(scans)
        budget = device_entropy._default_budget(pays.shape[0])
        kept += [scans, testing.pack_scans_v1(scans),
                 testing.pack_scans_v2(scans)]
        for _ in range(6):
            pk.pack_blocks_plain(pays, lens)
            pk.pack_tiles_plain(pays, lens, budget)
            pk.pack_blocks(pays, lens)
            pk.pack_tiles(pays, lens, budget)
    torch.cuda.synchronize()
    return kept


def first_decodes(after: str, img, files, dev, card, out_dir):
    """The process's first decodes, split by stage, after `after`."""
    kept = route_load(img, dev) if after.startswith("routes") else []
    if after.endswith("empty_cache"):
        torch.cuda.empty_cache()
    runs = []
    for i in range(4):
        reserved = torch.cuda.memory_reserved(dev)
        ms, _, _ = staged(files["benchmark"], "HLG", dev)
        runs.append(dict(stages=ms, total=sum(ms.values()),
                         reserved=reserved))
        print(f"first-decode after {after}, decode {i} (benchmark HLG): "
              f"total {sum(ms.values()):.2f} ms | "
              + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
              + f" | reserved before it {reserved / 2**30:.2f} GiB | {card}",
              flush=True)
    del kept
    (out_dir / f"decode_first_{after}.json").write_text(json.dumps(
        dict(card=card, after=after, runs=runs), indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out",
                    help="directory for the JSON summary and the traces")
    ap.add_argument("--first-decode", metavar="AFTER",
                    choices=("encode", "routes", "routes+empty_cache"),
                    help="measure only the process's first decodes after "
                    "AFTER")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: CUDA is not available")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda", 0)
    img = testing.photo_p010(W, H)
    files = {}
    for cfg, (scale, multichannel) in CONFIGS.items():
        enc = port.UhdrEncoder(device="cuda")
        enc.set_raw_image(img, port.ImgLabel.HDR)
        enc.set_gainmap_scale_factor(scale)
        enc.set_using_multi_channel_gainmap(multichannel)
        files[cfg] = enc.encode()
    if args.first_decode:
        return first_decodes(args.first_decode, img, files, dev, card,
                             out_dir)
    result = {"card": card, "requests": {}, "stages": {}, "busy": {}}

    for cfg, data in files.items():
        for out in OUTPUTS:
            for _ in range(2):
                request(data, out)
            ts = [timed_ms(lambda: request(data, out))
                  for _ in range(REPS)]
            med, q = statistics.median(ts), statistics.quantiles(ts, n=4)
            result["requests"][f"{cfg} {out}"] = dict(
                median=med, q1=q[0], q3=q[2], all=ts)
            print(f"request {cfg} {out}: median {med:.2f} ms (quartiles "
                  f"{q[0]:.2f}-{q[2]:.2f}, n={REPS}), "
                  f"{W * H / med / 1e3:.1f} MP/s | {card}", flush=True)

    for cfg, data in files.items():
        for out in ("HLG", "LINEAR"):
            for _ in range(2):
                staged(data, out, dev)
            runs = [staged(data, out, dev) for _ in range(REPS)]
            med = {k: statistics.median(r[0][k] for r in runs)
                   for k in runs[0][0]}
            result["stages"][f"{cfg} {out}"] = dict(
                median=med, down_bytes=runs[0][1], up_bytes=runs[0][2],
                total=sum(med.values()))
            print(f"stages {cfg} {out} (median of {REPS}, ms): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
                  + f" | total {sum(med.values()):.2f} | up "
                  f"{runs[0][2] / 1e6:.1f} MB, down {runs[0][1] / 1e6:.1f} MB"
                  f" | {card}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    for cfg, data in files.items():
        request(data, "HLG")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed_ms(lambda: [request(data, "HLG") for _ in range(3)])
        path = out_dir / f"decode_trace_{cfg}.json"
        prof.export_chrome_trace(str(path))
        busy, counts, top = busy_share(path)
        share = busy / 1e3 / wall
        result["busy"][cfg] = dict(busy_ms=busy / 1e3, wall_ms=wall,
                                   share=share, counts=counts, top=top)
        print(f"busy {cfg} HLG: device busy {busy / 1e3:.2f} ms of "
              f"{wall:.2f} ms wall over 3 requests = {100 * share:.1f}% | "
              f"events {counts} | top kernels (us, 3 requests): {top} | "
              f"{card}", flush=True)

    for cfg, out in (("benchmark", "HLG"), ("default", "HLG"),
                     ("default", "LINEAR")):
        request(files[cfg], out)
        prof = cProfile.Profile()
        prof.enable()
        request(files[cfg], out)
        torch.cuda.synchronize()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
        print(f"cprofile {cfg} {out} (tottime):\n" + "\n".join(
            ln[:150] for ln in text.getvalue().splitlines()[:40]
            if ln.strip()), flush=True)

    g3 = torch.randint(0, 256, (3, H, W), dtype=torch.uint8, device=dev)

    def on_host():
        return np.ascontiguousarray(np.moveaxis(g3.cpu().numpy(), 0, -1))

    def on_device():
        return g3.permute(1, 2, 0).contiguous().cpu().numpy()

    if not np.array_equal(on_host(), on_device()):
        raise AssertionError("host and device interleave differ")
    tt = {"host": [], "device": []}
    for i in range(20):
        order = ("host", "device") if i % 2 == 0 else ("device", "host")
        for name in order:
            tt[name].append(timed_ms(on_host if name == "host"
                                     else on_device))
    result["interleave"] = {k: dict(median=statistics.median(v), all=v)
                            for k, v in tt.items()}
    print(f"gain-map interleave 3x{H}x{W} u8 incl. download: host transpose "
          f"median {statistics.median(tt['host']):.2f} ms, device permute "
          f"median {statistics.median(tt['device']):.2f} ms (n=20, "
          f"alternating) | {card}", flush=True)
    (out_dir / "decode_profile.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
