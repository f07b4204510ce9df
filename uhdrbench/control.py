"""Readings that the limits of a cell's compared numbers are set from.

    python3 -m uhdrbench.control --workload <cell> --seeds 1 2 3 ...
        [--out chiprun_out/control.json]

For each seed: the program's numbers (each image of the seed's pool sent
once through the public API, its output checked as a run checks it) and
the control's (the reference computed in bfloat16 in the program's place,
compared with the float64 reference by the same numbers).  Needs the card
unless ``--device cpu``; ``--size WxH`` shrinks the configuration for a
run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def readings(name: str, seed: int, device: str = "cuda", size=None,
             control: bool = True) -> dict:
    import torch
    from . import harness, scene
    from .reference import codec
    cell, cfg = harness.load_cell(name)
    if size is not None:
        cfg = dict(cfg, width=size[0], height=size[1])
    port = harness.Port(device)
    items = harness.make_inputs(cell, cfg, seed, device)
    keeper = harness.Keeper(seed)
    for key, item in enumerate(items):
        keeper(key, port.decode(cell, item) if cell["op"] == "decode"
               else port.encode(cfg, item))
    prog = harness.check(cell, cfg, items, keeper, seed, device).result()
    res = {"seed": seed, "program": prog}
    if not control:
        return res
    xmp = cfg["metadata"] == "XMP"
    worst = {}
    pool = scene.pool(cfg["width"], cfg["height"], cell["pool"], seed)
    with torch.no_grad():
        for key, (y, uv) in enumerate(pool):
            yt, uvt = (torch.from_numpy(p.view(np.int16)).to(device)
                       for p in (y, uv))
            if cell["op"] == "decode":
                e = codec.encode_expectation(cfg, yt, uvt, xmp=xmp)
                want = codec.decode_expectation(cfg, e, cell["out_transfer"],
                                                xmp=xmp)
                got = codec.decode_expectation(cfg, e, cell["out_transfer"],
                                               xmp=xmp,
                                               dtype=torch.bfloat16)
            else:
                sdr = None
                if cell["op"] == "encode_api1":
                    sdr = [torch.from_numpy(p).to(device)
                           for p in items[key][2]]
                want = codec.encode_expectation(cfg, yt, uvt, sdr)
                got = codec.encode_expectation(cfg, yt, uvt, sdr,
                                               dtype=torch.bfloat16)
            for k, v in codec.compare_expectations(
                    got, want, "decode" if cell["op"] == "decode"
                    else "encode").items():
                worst[k] = max(worst.get(k, 0.0), v)
            del got, want
    res["control"] = worst
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also run the control")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    rows = []
    for name in args.workload:
        for i, s in enumerate(args.seeds):
            r = readings(name, s, args.device, size,
                         control=i < args.control_seeds)
            r["workload"] = name
            print(json.dumps(r), flush=True)
            rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
