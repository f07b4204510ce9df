"""The benchmark's command: one run of one cell.

    python3 -m uhdrbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  Prints earlier lines, then the result
line (JSON) last on standard output; each compared number and its limit go
last on standard error.  Without a CUDA card it exits 3 and prints no
result.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    cache = ROOT / "uhdrbench" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    import json
    import torch
    chips = next((w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"uhdrbench: {chips} CUDA card(s) needed; nothing is measured",
              file=sys.stderr)
        return 3
    from uhdrbench import harness
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    return 0 if res is not None else 1


if __name__ == "__main__":
    sys.exit(main())
