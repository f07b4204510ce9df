"""Phase split of the pipelined API-0 P010 encode over the upload wire.

    python -m libultrahdr_tpu_torch.tools.profile_encode_pipeline \\
        [--frames 8] [--reps 3] [--width 3840] [--height 2160] \\
        [--modes vw,auto] [--configs benchmark,default] [--device cuda] \\
        [--out DIR]

The port's counterpart of the JAX package's
``tools/profile_encode_pipeline.py``.  Each frame (``testing.photo_p010``,
seeds 17 on) goes up over its own wire, as the port's pipelined encode
sends an image that is alone in its unit with ``UHDR_TPU_WIRE`` set (the
K-batch route, ``fused._dispatch_batch``, is timed by chip_smoke phase
22).  Per frame and wire mode, the stages of ``fused._dispatch_p010``
and its drain, run one after the other and each timed alone:

- pack: the host pack of the wire (``wire._pack_wire_auto``: for "vw"
  ``native.pack_vw_into`` of both planes), host clock;
- upload: one pinned upload of the wire buffer (``wire._upload``) and a
  synchronize, host clock; beside it the raw route's upload of the planes;
- device: the wire's device half (the un-slice and the delta cumsums),
  steps 1-4 and the pack launch, CUDA events; within it the un-slice
  kernel's share, CUDA events around each ``wire_kernel.unslice`` call;
- drain: the word download, the host join and the container, host clock.

Then the pipelined call itself (``fused.encode_api0_p010_pipelined`` of all
frames), raw and over each mode in turns (raw, the modes, the modes
reversed, raw, `reps` times), as ms an image.  Every file equals the raw
route's byte for byte.  Medians are reported unrounded, with the card's
name and power limit (``nvidia-smi``).  The last line printed is one JSON
object; ``--out DIR`` also writes it to ``DIR/encode_pipeline_profile.json``.

``--device cpu`` runs the same stages with no streams and reports no
device metric (``device_ms`` and ``unslice_ms`` null, ``compute_host_ms``
the host clock around the stage): the CPU test's route.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

CONFIGS = {"benchmark": dict(map_dimension_scale_factor=4,
                             use_multi_channel_gainmap=False),
           "default": {}}


@contextlib.contextmanager
def _wire_knob(value: str | None):
    """UHDR_TPU_WIRE set to `value` (None: unset) for the block."""
    old = os.environ.get("UHDR_TPU_WIRE")
    if value is None:
        os.environ.pop("UHDR_TPU_WIRE", None)
    else:
        os.environ["UHDR_TPU_WIRE"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("UHDR_TPU_WIRE", None)
        else:
            os.environ["UHDR_TPU_WIRE"] = old


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.splitlines()[0] if out else None


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def _split(jr, img, mode: str, dev, slot):
    """One frame through the wire route's stages, each timed alone, on
    `slot` (a ``fused._Slot``; None on the CPU).  The "vw" wire is packed
    by ``wire.pack_vw_wire``, what ``UHDR_TPU_WIRE=vw`` packs, with no knob
    set; another mode through the knob.  Returns (stage ms and the wire's
    bytes, the file)."""
    import torch

    from .. import fused, wire
    from ..jpeg import pack_kernel
    from ..types import ColorGamut, ColorRange, ColorTransfer

    h, w = img.h, img.w
    cuda = slot is not None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    planes = fused._p010_planes(img)
    t0 = time.perf_counter()
    if mode == "vw":
        buf, wmode = wire.pack_vw_wire(*planes)
    else:
        with _wire_knob(mode):
            buf, wmode = wire._pack_wire_auto(*planes)
    pack_ms = (time.perf_counter() - t0) * 1e3
    if buf is None:
        raise RuntimeError(f"UHDR_TPU_WIRE={mode}: the frame fits no wire")
    sync()
    t0 = time.perf_counter()
    buf_d = wire._upload(buf, dev)
    sync()
    upload_ms = (time.perf_counter() - t0) * 1e3

    cg, ct = ColorGamut(img.cg), ColorTransfer(img.ct)
    scale = fused._resolve_scale(jr, img)
    use_base_cg = fused._use_base_cg(ColorGamut.DISPLAY_P3, cg, jr.write_xmp)
    pairs = []
    real_unslice = wire.wire_kernel.unslice

    def timed_unslice(*a, **kw):
        if not cuda:
            return real_unslice(*a, **kw)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = real_unslice(*a, **kw)
        end.record()
        pairs.append((start, end))
        return out

    wire.wire_kernel.unslice = timed_unslice
    try:
        with (torch.cuda.stream(slot.stream) if cuda
              else contextlib.nullcontext()):
            first = last = None
            if cuda:
                first, last = (torch.cuda.Event(enable_timing=True)
                               for _ in range(2))
                first.record()
            t0 = time.perf_counter()
            y, uv = wire.decode_p010_wire(buf_d, h, w, wmode)
            scans = fused._api0_p010_block_buffers(
                y, uv, cg=cg, ct=ct, rng=ColorRange(img.range), scale=scale,
                multichannel=jr.use_multi_channel_gainmap, gamma=jr.gamma,
                quality=95, map_quality=jr.map_compress_quality,
                use_base_cg=use_base_cg)
            words, blen = fused._pack_scans(
                scans, slot.pack if cuda else pack_kernel.pack_scan)
            event = None
            if cuda:
                last.record()
                event = fused.sleeping_event()
                event.record(slot.stream)
        sync()
        compute_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        wire.wire_kernel.unslice = real_unslice
    device_ms = first.elapsed_time(last) if cuda else None
    unslice_ms = sum(a.elapsed_time(b) for a, b in pairs) if cuda else None

    t0 = time.perf_counter()
    job = fused._EncodeJob([img], scale, fused._onepass_metadata(
        jr, ct, use_base_cg), [lay for _, lay in scans], words, blen, slot,
        event)
    data = fused._container_p010(jr, job, img, fused._join_p010(job)[0], 95,
                                 None)
    drain_ms = (time.perf_counter() - t0) * 1e3
    return dict(wire=wire._wire_name(wmode), wire_bytes=buf.nbytes,
                wire_mb=buf.nbytes / 1e6,
                pack_ms=pack_ms, upload_ms=upload_ms, device_ms=device_ms,
                unslice_ms=unslice_ms, compute_host_ms=compute_host_ms,
                drain_ms=drain_ms), data


def run(frames: int = 8, reps: int = 3, width: int = 3840,
        height: int = 2160, modes=("vw", "auto"),
        configs=("benchmark", "default"), device: str = "cuda") -> dict:
    """The profile as a dict (see the module docstring)."""
    import torch

    from .. import fused, testing
    from ..jpegr import JpegR

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_encode_pipeline: CUDA is not available; "
                         "pass --device cpu for the CPU route")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    imgs = [testing.photo_p010(width, height, seed=17 + i)
            for i in range(frames)]
    result = {"device": {"type": dev.type,
                         "name": torch.cuda.get_device_name(dev)
                         if cuda else "cpu",
                         "card": _card() if cuda else None},
              "width": width, "height": height, "frames": frames,
              "reps": reps, "configs": {}}
    for cfg in configs:
        jr = JpegR(device=device, **CONFIGS[cfg])
        # one slot reused by every frame, as the pipelined encode reuses its
        # slots (its pinned buffers grow once)
        slot = None
        if cuda:
            fused.prepare_device(dev)
            slot = fused._Slot(dev, fused.side_streams(dev)[0])
        with _wire_knob(None):
            raw_files = fused.encode_api0_p010_pipelined(jr, imgs, 95)
        planes = fused._p010_planes(imgs[0])
        raw_up = []
        for _ in range(max(reps, 1)):
            sync()
            t0 = time.perf_counter()
            fused.upload_planes(planes, dev)
            sync()
            raw_up.append((time.perf_counter() - t0) * 1e3)
        out = {"raw": {"upload_mb": sum(p.nbytes for p in planes) / 1e6,
                       "upload_ms": _median(raw_up),
                       "pipelined_ms_per_image": []}}
        for mode in modes:
            stages = []
            for _ in range(reps):
                for i, img in enumerate(imgs):
                    st, data = _split(jr, img, mode, dev, slot)
                    if data != raw_files[i]:
                        raise AssertionError(f"{cfg} UHDR_TPU_WIRE={mode}: "
                                             f"frame {i} != the raw file")
                    stages.append(st)
            out[mode] = {"wires": sorted({s["wire"] for s in stages}),
                         "pipelined_ms_per_image": []}
            for k in ("wire_mb", "pack_ms", "upload_ms", "device_ms",
                      "unslice_ms", "compute_host_ms", "drain_ms"):
                out[mode][k] = _median([s[k] for s in stages])
        order = ["raw", *modes, *reversed(modes), "raw"]
        for _ in range(reps):
            for route in order:
                with _wire_knob(None if route == "raw" else route):
                    sync()
                    t0 = time.perf_counter()
                    files = fused.encode_api0_p010_pipelined(jr, imgs, 95)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3 / frames
                if files != raw_files:
                    raise AssertionError(f"{cfg} pipelined over {route}: "
                                         "files != the raw route's")
                out[route]["pipelined_ms_per_image"].append(ms)
        result["configs"][cfg] = out
    result["files_equal_raw"] = True
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--modes", default="vw,auto")
    ap.add_argument("--configs", default="benchmark,default")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    res = run(args.frames, args.reps, args.width, args.height,
              tuple(args.modes.split(",")), tuple(args.configs.split(",")),
              args.device)
    line = json.dumps(res)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "encode_pipeline_profile.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
