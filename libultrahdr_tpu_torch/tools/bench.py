"""The headline benchmark on the card: the port's counterpart of the JAX
repository's ``bench.py``.

    python -m libultrahdr_tpu_torch.tools.bench [--device cuda|cpu]
        [--size 3840x2160]

The reference benchmark's API-0 configuration (P010 BT2100 HLG input, q95,
one-pass gain map) and its decode, on the photo scene
(``testing.photo_p010``), host clock, every call on the card ending in
``torch.cuda.synchronize()`` inside the clock:

- headline ``api0_encode_4k_p010_hlg``: the best of 5 MP/s of
  ``fused.encode_api0_p010_pipelined`` over 8 rolled images with
  ``JpegR(map_dimension_scale_factor=4, use_multi_channel_gainmap=False,
  preset=0)``, after a warm call on 4; every file must equal
  ``jr.encode_api0`` of its image, byte for byte;
- extras: ``encode_median_4k_mpps``; ``decode_host_4k_hlg_mpps``
  (``decode_host``, median of 5); ``decode_serving_4k_hlg_mpps`` (8
  ``decode_to_device`` clients on a pool, the microbatcher at its
  defaults, median of 3 rounds); ``decode_device_single_4k_hlg_mpps``
  (``decode_to_device(microbatch=False)``, median of 5);
  ``link_h2d_mbps`` (an 8 MB pinned host-to-card copy, best of 3);
  ``encode_wire_bytes_per_img``, ``encode_wire_mode`` and
  ``encode_device_compute_4k_ms`` (image 0 over the vw wire, its device
  stage timed by CUDA events: ``profile_encode_pipeline._split``, median
  of 5; each file equal to the pipelined one); the
  ``grainy`` and ``mosaic`` encode (best of 3 over 4 images) and
  ``decode_host`` (median of 3) rows.  ``launches`` holds the kernel
  launches of the timed pipelined calls beside ``encode_calls``, the
  images they encoded.

Prints one JSON line, ``{"metric", "value", "unit", "extra"}``; ``extra``
names the card and its power limit as nvidia-smi prints them.  An error
propagates.  ``--device cpu`` runs the same calls on CPU tensors (no
device metric: ``link_h2d_mbps`` and ``encode_device_compute_4k_ms`` are
null); without a GPU the default ``cuda`` raises ``UhdrError``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

W, H = 3840, 2160
BATCH = 8          # images in flight: overlaps upload, compute, download
ENC_REPS = 5
DEC_REPS = 5


def make_scene(w, h, seed=11, phase=0.0):
    """Synthetic natural HDR scene in P010 planes (benchmarks.py's
    fallback content when the committed fixtures are absent)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.45 + 0.3 * np.sin(xx / 700.0 + 1.3 + phase) * np.cos(yy / 500.0)
    blobs = (0.35 * np.exp(-(((xx - 2600) / 520.0) ** 2
                             + ((yy - 700) / 380.0) ** 2))
             + 0.5 * np.exp(-(((xx - 900) / 300.0) ** 2
                              + ((yy - 1500) / 260.0) ** 2)))
    rs = np.random.RandomState(seed)
    tex = rs.randn(h // 8, w // 8).astype(np.float32)
    tex = np.kron(tex, np.ones((8, 8), np.float32)) * 0.015
    lum = np.clip(base + blobs + tex, 0.0, 1.0)
    yp = (np.clip(lum * 1023.0, 0, 1023).astype(np.uint16) << 6)
    u = 0.5 + 0.18 * np.sin(xx[::2, :] / 900.0) * np.cos(yy[::2, :] / 650.0)
    uvp = np.empty((h // 2, w), np.uint16)
    uvp[:, 0::2] = (np.clip(u[:, 0::2] * 1023.0, 0, 1023)
                    .astype(np.uint16) << 6)
    uvp[:, 1::2] = (np.clip((1.0 - u)[:, 1::2] * 1023.0, 0, 1023)
                    .astype(np.uint16) << 6)
    return yp, uvp


def _scene_imgs(maker, k=BATCH, w=None, h=None):
    """k distinct-but-statistically-matched images: slide the scene
    (even column offsets keep interleaved U/V in their lanes); (w, h)
    defaults to (W, H)."""
    from ..types import (ColorGamut, ColorRange, ColorTransfer, ImgFmt,
                         RawImage)
    w, h = w or W, h or H
    base = maker(w, h)
    imgs = []
    for i in range(k):
        yp = np.ascontiguousarray(np.roll(base.planes[0], (8 * i, 32 * i),
                                          axis=(0, 1)))
        uvp = np.ascontiguousarray(np.roll(base.planes[1], (4 * i, 32 * i),
                                           axis=(0, 1)))
        imgs.append(RawImage(ImgFmt.P010, ColorGamut.BT2100,
                             ColorTransfer.HLG, ColorRange.FULL, w, h,
                             [yp, uvp]))
    return imgs


class Bench:
    """The calls of one run on `jr.device`, each ending in a synchronize
    on the card."""

    def __init__(self, jr, d):
        import torch
        self.jr, self.d = jr, d
        self.cuda = jr.device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)

    def _clock(self, f):
        t0 = time.perf_counter()
        out = f()
        self.sync()
        return time.perf_counter() - t0, out

    def encode(self, imgs, reps=ENC_REPS):
        """(best MP/s, median MP/s, files, launches of the timed calls);
        raises unless every file equals ``encode_api0`` of its image."""
        from .. import fused
        from .benchmarks import read_launches, zero_launches
        fused.encode_api0_p010_pipelined(self.jr, imgs[:4], quality=95)
        self.sync()
        zero_launches()
        ts = []
        for _ in range(reps):
            dt, outs = self._clock(lambda: fused.encode_api0_p010_pipelined(
                self.jr, imgs, quality=95))
            ts.append(dt / len(imgs))
        launches = read_launches()
        for i, (img, data) in enumerate(zip(imgs, outs)):
            if data != self.jr.encode_api0(img, quality=95):
                raise AssertionError(f"pipelined file {i} != encode_api0 "
                                     "of its image")
        mp = imgs[0].w * imgs[0].h / 1e6
        return (mp / min(ts), mp / statistics.median(ts), outs, launches)

    def decode_host(self, data, reps=DEC_REPS):
        from ..types import ColorTransfer
        self.d.decode_host(data, output_ct=ColorTransfer.HLG)  # warm
        ts = []
        for _ in range(reps):
            dt, (dest, _) = self._clock(lambda: self.d.decode_host(
                data, output_ct=ColorTransfer.HLG))
            ts.append(dt)
        if dest.planes[0].dtype != np.uint32:
            raise AssertionError(f"decode_host gave {dest.planes[0].dtype}")
        return dest.w * dest.h / 1e6 / statistics.median(ts)

    def decode_serving(self, streams, w, h, clients=8, rounds=3):
        """N concurrent decode_to_device callers, outputs on the card,
        requests coalescing through the default microbatcher; the clock
        stops after the pool's map and a synchronize of the card."""
        import concurrent.futures as cf

        from ..types import ColorTransfer

        def one(data):
            return self.d.decode_to_device(data,
                                           output_ct=ColorTransfer.HLG)[0]

        with cf.ThreadPoolExecutor(clients) as ex:
            list(ex.map(one, streams[:clients]))      # warm
            self.sync()
            ts = []
            for _ in range(rounds):
                dt, _ = self._clock(lambda: list(ex.map(
                    one, streams[:clients])))
                ts.append(dt / clients)
        return w * h / 1e6 / statistics.median(ts)

    def decode_device_single(self, streams, w, h, reps=DEC_REPS):
        """The per-image device-resident route (microbatcher off), one
        request at a time; the first call is the warm one."""
        from ..types import ColorTransfer
        ts = []
        for i in range(reps + 1):
            src = streams[i % len(streams)]
            dt, _ = self._clock(lambda: self.d.decode_to_device(
                src, output_ct=ColorTransfer.HLG, microbatch=False))
            if i:
                ts.append(dt)
        return w * h / 1e6 / statistics.median(ts)

    def link_h2d_mbps(self):
        """An 8 MB pinned host-to-card copy, best of 3 (MB/s)."""
        import torch
        rs = np.random.RandomState(0)
        probe = torch.from_numpy(rs.randint(
            0, 2 ** 31, size=2 * 1024 * 1024, dtype=np.int32)).pin_memory()
        best = 0.0
        for _ in range(3):
            dt, _ = self._clock(lambda: probe.to(self.jr.device,
                                                 non_blocking=True))
            best = max(best, probe.numel() * 4 / dt / 1e6)
        return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--size", default=f"{W}x{H}", metavar="WxH")
    args = ap.parse_args(argv)

    from .. import fused
    from ..jpegr import JpegR, resolve_device
    from . import benchmarks
    from .profile_encode_pipeline import _split
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.lower().split("x"))
    jr = JpegR(map_dimension_scale_factor=4, use_multi_channel_gainmap=False,
               preset=0, device=str(dev))
    b = Bench(jr, JpegR(device=str(dev)))

    extra = {"scene": "photo", "size": f"{w}x{h}",
             "card": benchmarks.card_name(dev),
             "link_h2d_mbps": b.link_h2d_mbps() if b.cuda else None,
             "encode_reps": ENC_REPS, "decode_reps": DEC_REPS,
             "stat": "best-of-reps (headline), median (extras)"}

    # ---------------- photo scene (headline) ----------------
    imgs = _scene_imgs(benchmarks.photo_p010, w=w, h=h)
    enc_best, enc_med, outs, launches = b.encode(imgs)
    extra["encode_median_4k_mpps"] = enc_med
    extra["encode_calls"] = ENC_REPS * len(imgs)
    extra["launches"] = launches
    extra["pipelined_equal_single"] = True
    extra["decode_host_4k_hlg_mpps"] = b.decode_host(outs[0])
    extra["decode_serving_4k_hlg_mpps"] = b.decode_serving(outs, w, h)
    extra["decode_device_single_4k_hlg_mpps"] = b.decode_device_single(
        outs, w, h)

    # image 0 over the vw wire: its bytes and its device stage
    slot = None
    if b.cuda:
        fused.prepare_device(dev)
        slot = fused._Slot(dev, fused.side_streams(dev)[0])
    device_ms = []
    for _ in range(DEC_REPS):
        stages, data = _split(jr, imgs[0], "vw", dev, slot)
        if data != outs[0]:
            raise AssertionError("image 0 over the vw wire != its "
                                 "pipelined file")
        device_ms.append(stages["device_ms"])
    extra["encode_wire_bytes_per_img"] = stages["wire_bytes"]
    extra["encode_wire_mode"] = stages["wire"]
    extra["encode_device_compute_4k_ms"] = (statistics.median(device_ms)
                                            if b.cuda else None)

    # ---------------- other scenes ----------------
    for scene, maker in (("grainy", benchmarks.grainy_p010),
                         ("mosaic", benchmarks.natural_p010)):
        simgs = _scene_imgs(maker, 4, w=w, h=h)
        e_best, _, souts, _ = b.encode(simgs, reps=3)
        extra[f"encode_{scene}_4k_mpps"] = e_best
        extra[f"decode_host_{scene}_4k_mpps"] = b.decode_host(souts[0],
                                                              reps=3)

    print(json.dumps({"metric": "api0_encode_4k_p010_hlg",
                      "value": enc_best, "unit": "MP/s", "extra": extra}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
