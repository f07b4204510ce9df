"""One run of one cell: set-up, the measured window of closed-loop
clients calling the port's public API, the check of what the window
produced, and the result line.

A cell is ``workloads/<name>.json``; its configuration is
``configs/<config>.json``; its per-layer metrics are the entries of
``BENCHMARK.json`` that list it, each read by ``metrics/<metric>.py``.
Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import ast
import gc
import importlib.util
import json
import math
import os
import pathlib
import random
import statistics
import sys
import threading
import time

import numpy as np

from . import scene, trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
PEAKS = json.loads((HERE / "peaks.json").read_text())
FORBIDDEN = ("jax", "jaxlib", "flax", "libultrahdr_tpu")


def load_cell(name: str):
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json")
                     .read_text())
    return cell, cfg


def benchmark_entries(name: str):
    """(end-to-end metrics, per-layer metrics) of BENCHMARK.json that the
    cell reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    def has(m):
        return "workloads" not in m or name in m["workloads"]
    return ([m for m in bench["end_to_end"] if has(m)],
            [m for m in bench["per_layer"] if has(m)])


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "uhdrbench_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def reference_imports() -> set:
    """The top-level names that the reference's sources import."""
    names = set()
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
    return names


# ---------------------------------------------------------------------------
# requests through the public API

class Port:
    """The port's public API and the enums a request needs."""

    def __init__(self, device: str):
        from libultrahdr_tpu_torch import api, types
        from libultrahdr_tpu_torch.jpeg import native
        self.api, self.t, self.native = api, types, native
        self.device = device

    def raw_p010(self, cfg, y, uv):
        t = self.t
        return t.RawImage(t.ImgFmt.P010, t.ColorGamut[cfg["hdr_gamut"]],
                          t.ColorTransfer[cfg["hdr_transfer"]],
                          t.ColorRange.FULL, cfg["width"], cfg["height"],
                          [y, uv])

    def raw_yuv420(self, cfg, planes):
        t = self.t
        return t.RawImage(t.ImgFmt.YUV420, t.ColorGamut.DISPLAY_P3,
                          t.ColorTransfer.SRGB, t.ColorRange.FULL,
                          cfg["width"], cfg["height"], list(planes))

    def encode(self, cfg, item) -> bytes:
        """uhdr_encode of one image: API-0 for (y, uv), API-1 for (y, uv,
        sdr planes); one fresh encoder a request."""
        t = self.t
        enc = self.api.UhdrEncoder(device=self.device)
        enc.set_raw_image(self.raw_p010(cfg, item[0], item[1]),
                          t.ImgLabel.HDR)
        if len(item) > 2:
            enc.set_raw_image(self.raw_yuv420(cfg, item[2]), t.ImgLabel.SDR)
        enc.set_quality(cfg["base_quality"], t.ImgLabel.BASE)
        enc.set_quality(cfg["map_quality"], t.ImgLabel.GAIN_MAP)
        enc.set_gainmap_scale_factor(cfg["map_scale"])
        enc.set_using_multi_channel_gainmap(cfg["multichannel_map"])
        enc.set_gainmap_gamma(cfg["gamma"])
        enc.set_preset(t.EncPreset[cfg["preset"]])
        return enc.encode()

    def decode(self, cell, data: bytes) -> np.ndarray:
        """uhdr_decode of one file to the cell's output; the packed pixels
        in host memory."""
        t = self.t
        dec = self.api.UhdrDecoder(device=self.device)
        dec.set_image(data)
        dec.set_out_color_transfer(t.ColorTransfer[cell["out_transfer"]])
        dec.set_out_img_format(t.ImgFmt[cell["out_format"]])
        img = dec.decode()
        return np.asarray(img.planes[0])


# ---------------------------------------------------------------------------
# inputs

def make_inputs(cell, cfg, seed: int, device: str):
    """The cell's pool from the seed: P010 images (API-0), P010 + SDR
    rendition pairs (API-1), or files of the plain writer (decode)."""
    import torch
    from .reference import codec
    imgs = scene.pool(cfg["width"], cfg["height"], cell["pool"], seed)
    if cell["op"] == "encode_api0":
        return imgs
    out = []
    for y, uv in imgs:
        yt, uvt = (torch.from_numpy(p.view(np.int16)).to(device)
                   for p in (y, uv))
        if cell["op"] == "encode_api1":
            out.append((y, uv, codec.sdr_rendition(yt, uvt, cfg)))
        else:
            exp = codec.encode_expectation(cfg, yt, uvt,
                                           xmp=cfg["metadata"] == "XMP")
            out.append(codec.write_file(cfg, exp, cfg["metadata"] == "XMP"))
        del yt, uvt
    return out


# ---------------------------------------------------------------------------
# the window

class Window:
    """Closed-loop clients: each sends its next request when its last one
    has returned, cycling through the pool in its own seeded order, until
    the window closes; requests in flight then finish (and are not
    counted)."""

    def __init__(self, fn, items, clients: int, seed: int, keep):
        self.fn, self.items, self.clients = fn, items, clients
        self.keep = keep
        r = scene.rng(seed, 2)
        n = len(items)
        self.orders = [list(r.permutation(n)) for _ in range(clients)]
        self.records = []          # (client, start, end, key, error)
        self.lock = threading.Lock()
        self.thread_cpu = [0.0] * clients

    def run(self, seconds: float):
        self.t0 = time.perf_counter() + 0.05
        self.t1 = self.t0 + seconds
        threads = [threading.Thread(target=self._client, args=(c,))
                   for c in range(self.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return self

    def _client(self, c):
        order = self.orders[c]
        i = c * len(order) // max(self.clients, 1)
        while time.perf_counter() < self.t0:
            time.sleep(0.001)
        cpu0 = time.thread_time()
        while True:
            s = time.perf_counter()
            if s >= self.t1:
                self.thread_cpu[c] = time.thread_time() - cpu0
                return
            key = int(order[i % len(order)])
            i += 1
            err, out = None, None
            try:
                out = self.fn(self.items[key])
            except Exception as e:       # a failed request is recorded
                err = f"{type(e).__name__}: {e}"
            e = time.perf_counter()
            with self.lock:
                self.records.append((c, s, e, key, err))
                if err is None:
                    self.keep(key, out)

    def completed(self):
        return [r for r in self.records if r[4] is None and r[2] <= self.t1]

    def failed(self):
        return [r for r in self.records if r[4] is not None]


def host_usage(cpu0: float, win) -> dict:
    """The process's CPU seconds over the window: all its threads, and the
    clients' own."""
    return {"cpu_s": time.process_time() - cpu0,
            "clients_cpu_s": sum(win.thread_cpu)}


def per_second(done, t0: float, seconds: float) -> list:
    """Requests completed in each second of the window."""
    counts = [0] * max(1, math.ceil(seconds))
    for r in done:
        counts[min(len(counts) - 1, int(r[2] - t0))] += 1
    return counts


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Keeper:
    """What the check and the readers see of the window's outputs: for
    each pool item the number of requests that returned it and one of
    their outputs, drawn by a seeded reservoir."""

    def __init__(self, seed: int):
        self.served = {}          # key -> requests
        self.kept = {}            # key -> one output
        self.rng = random.Random(int(seed))

    def __call__(self, key, out):
        n = self.served.get(key, 0) + 1
        self.served[key] = n
        if self.rng.randrange(n) == 0:
            self.kept[key] = out

    def outputs(self):
        return [(f"pool{k}", self.kept[k], k) for k in sorted(self.kept)]

    def clear(self):
        self.served.clear()
        self.kept.clear()


# ---------------------------------------------------------------------------
# correctness

MAX_CHECKED = 4
WARM_ROUNDS = 4


def check(cell, cfg, items, keeper, seed: int, device: str):
    """The compared numbers of the window's outputs against the plain
    reference (float64 on the device)."""
    import torch
    from .reference import codec
    outs = keeper.outputs()
    if len(outs) > MAX_CHECKED:
        outs = random.Random(int(seed)).sample(outs, MAX_CHECKED)
    pool = scene.pool(cfg["width"], cfg["height"], cell["pool"], seed)
    xmp = cfg["metadata"] == "XMP"
    exps = {}
    with torch.no_grad():
        for key in sorted({k for _, _, k in outs}):
            y, uv = (torch.from_numpy(p.view(np.int16)).to(device)
                     for p in pool[key])
            if cell["op"] == "decode":
                e = codec.encode_expectation(cfg, y, uv, xmp=xmp)
                exps[key] = codec.decode_expectation(
                    cfg, e, cell["out_transfer"], xmp=xmp)
            else:
                sdr = None
                if cell["op"] == "encode_api1":
                    sdr = [torch.from_numpy(p).to(device)
                           for p in items[key][2]]
                exps[key] = codec.encode_expectation(cfg, y, uv, sdr)
        if cell["op"] == "decode":
            return codec.check_decode(outs, exps)
        return codec.check_encode(outs, exps, cfg)


def verdict(nums, limits: dict):
    """(correct, [(name, value, limit)]): every number that the cell
    gives a limit within it, the number of faults held to 0; a number
    without a limit is printed with the limit None and not compared."""
    res = nums.result()
    rows = [("faults", res.pop("faults"), 0.0)]
    rows += [(k, v, limits.get(k)) for k, v in sorted(res.items())]
    ok = nums.checked > 0 and all(lim is None or v <= lim
                                  for _, v, lim in rows)
    return ok, rows


# ---------------------------------------------------------------------------
# the run

def process_seconds() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", size=None, out=print, err=None):
    """One run; returns the result dict (also printed as the last line of
    standard output by ``out``).  `size` (w, h) replaces the
    configuration's for a test on the CPU."""
    import torch
    err = err or (lambda s: print(s, file=sys.stderr, flush=True))
    cell, cfg = load_cell(name)
    if size is not None:
        cfg = dict(cfg, width=size[0], height=size[1])
    e2e, per_layer = benchmark_entries(name)
    port = Port(device)
    mp = cfg["width"] * cfg["height"] / 1e6
    items = make_inputs(cell, cfg, seed, device)
    if cell["op"] == "decode":
        fn = lambda data: port.decode(cell, data)          # noqa: E731
    else:
        fn = lambda item: port.encode(cfg, item)           # noqa: E731
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gc.collect()
    sync()
    if on_card:          # the inputs' float64 work leaves the card's cache
        torch.cuda.empty_cache()
    # warm-up: rounds of the window's clients, each over its own item, so
    # that the caching allocators hold what concurrent requests use
    warm = Keeper(seed)
    for r in range(WARM_ROUNDS):
        w = Window(fn, items, cell["clients"], seed, warm)
        threads = [threading.Thread(target=_one_each, args=(w, c, r))
                   for c in range(cell["clients"])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if w.failed():
            raise RuntimeError(f"warm-up request failed: {w.failed()[0][4]}")
    warm.clear()
    gc.collect()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_seconds()
    from libultrahdr_tpu_torch.tools import benchmarks as port_counters
    port_counters.zero_launches()
    keeper = Keeper(seed)
    win = Window(fn, items, cell["clients"], seed, keeper)
    prof, usage = None, None
    if traced:
        spans = trace.Spans()
        win.fn = spans.wrap(fn, "uhdrbench.request")
        prof = trace.profile()
        with spans.around_port(port.native), prof:
            host_window = [time.perf_counter()]
            win.run(seconds)
            sync()
            host_window.append(time.perf_counter())
    else:
        cpu0 = time.process_time()
        win.run(seconds)
        sync()
        usage = host_usage(cpu0, win)
    counters = port_counters.read_launches()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    done = win.completed()
    failed = win.failed()
    lat = [r[2] - r[1] for r in done] + [math.inf] * len(failed)
    out(json.dumps({"requests": len(done), "failed": len(failed),
                    "in_flight_at_close": len(win.records) - len(done)
                    - len(failed),
                    "median_ms": 1e3 * statistics.median(lat) if lat
                    else None, "per_second": per_second(done, win.t0,
                                                        seconds),
                    "launches": counters, "host": usage,
                    "served": [keeper.served[k]
                               for k in sorted(keeper.served)]}))
    metrics, breakdown, dev_extra = {}, None, {}
    if traced:
        tr = trace.build(prof, spans.spans, host_window, [
            (r[1], r[2], mp) for r in win.records if r[4] is None],
            [(keeper.kept[k], keeper.served[k]) for k in sorted(keeper.kept)],
            cfg, cell, PEAKS["memory_bytes_per_s"])
        prof = None
        for m in per_layer:
            v = metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = trace.breakdown(tr)
        del tr
    else:
        values = {"mpps": mp * len(done) / seconds,
                  "p95_ms": 1e3 * p95(lat) if lat else math.inf,
                  "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    nums = check(cell, cfg, items, keeper, seed, device)
    ok, rows = verdict(nums, cell["limits"])
    bad = forbidden_modules()
    if bad:
        err(f"loaded modules of JAX or the JAX package: {bad}")
        raise SystemExit(4)
    bad = reference_imports() & {"libultrahdr_tpu_torch", *FORBIDDEN}
    if bad:
        err(f"the reference imports {sorted(bad)}")
        raise SystemExit(4)
    for f in nums.faults[:20]:
        err(f"fault: {f}")
    if failed:
        err(f"failed request: {failed[0][4]}")
    for name_, v, lim in rows:
        err(f"{name_} {v!r} limit {lim!r}")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    device_info.update(dev_extra)
    result = {"correct": bool(ok and not failed),
              "attempted": len(win.records), "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    out(json.dumps(result))
    return result


def _one_each(w, c, r):
    """Request r of client c in the warm-up."""
    key = (c + r * w.clients) % len(w.items)
    s = time.perf_counter()
    try:
        out = w.fn(w.items[key])
        err = None
    except Exception as e:           # reported by the caller
        out, err = None, f"{type(e).__name__}: {e}"
    with w.lock:
        w.records.append((c, s, time.perf_counter(), key, err))
        if err is None:
            w.keep(key, out)
