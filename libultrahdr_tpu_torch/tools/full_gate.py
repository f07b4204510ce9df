"""Segmented test gate: the test tier in one command, one pytest process a
test file.

    python libultrahdr_tpu_torch/tools/full_gate.py [--log FILE]
        [--files tests/test_x.py ...] [-m EXPR] [-- pytest args]

The port's counterpart of the JAX repository's ``tools/full_gate.py``.  It
runs each test file (default: every ``tests/test_*.py``) in a pytest process
of its own, from the repository root, with the tier-1 marker expression of
ROADMAP.md's "Tier-1 verify" (``-m 'not slow'``) unless ``-m`` names
another, and prints one line a segment and a verdict; ``--log`` writes the
same lines to a file, with each failing segment's output.  A segment that
dies on a signal, not on a failing test, is run once more in a fresh
process.  Exit 0 only when every segment is green: pytest's exit 0, or 5
(no test collected, as when the marker expression deselects a whole file).

Each segment's counts come from pytest's final summary line only (the last
line of the form "3 passed, 1 skipped in 0.12s", with or without the
surrounding "=" banner), so a count quoted anywhere else in the output, in
a failing assertion's message for one, is not added up.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
TIER1_MARKERS = "not slow"
KINDS = ("passed", "failed", "skipped", "xfailed", "xpassed", "errors",
         "deselected")
# pytest's final line: "N kind[, N kind ...] in 1.23s" (optionally "(0:01:02)"
# after the seconds), inside a "=" banner unless -q left it out
_SUMMARY = re.compile(r"^=*\s*((?:\d+ \w+(?:, )?)+|no tests ran) in "
                      r"[\d.]+s(?: \([\d:]+\))?\s*=*$")
_COUNT = re.compile(r"(\d+) (\w+)")


def _counts(output: str) -> dict:
    """The counts of pytest's final summary line in `output` (all 0 when
    there is none): passed, failed, skipped, xfailed, xpassed, errors,
    deselected."""
    got = dict.fromkeys(KINDS, 0)
    lines = [ln.strip() for ln in output.splitlines()
             if _SUMMARY.match(ln.strip())]
    if lines:
        for n, kind in _COUNT.findall(lines[-1]):
            kind = "errors" if kind in ("error", "errors") else kind
            if kind in got:
                got[kind] = int(n)
    return got


def run_segment(path: str, extra: list[str], log, cwd=REPO):
    """Run one test file in its own pytest process.  Returns (green,
    counts, crashed): crashed when the process died on a signal."""
    cmd = [sys.executable, "-m", "pytest", path, "-q", "--no-header",
           "-p", "no:cacheprovider", *extra]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=cwd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.time() - t0
    crashed = proc.returncode < 0 or proc.returncode >= 128
    green = proc.returncode in (0, 5)
    counts = _counts(proc.stdout)
    tag = "ok" if green else ("CRASH" if crashed else "FAIL")
    line = (f"[{tag:>5}] {path:<44} {seconds:7.1f}s  {counts['passed']} "
            f"passed, {counts['failed']} failed, {counts['errors']} errors, "
            f"{counts['skipped']} skipped")
    print(line, flush=True)
    log.write(line + "\n")
    if not green:
        log.write(proc.stdout + "\n")
    return green, counts, crashed


def gate(files: list[str], extra: list[str], log, cwd=REPO) -> tuple[bool,
                                                                     dict]:
    """Every file a segment (a crashed one retried once); returns (every
    segment green, the summed counts)."""
    total = dict.fromkeys(KINDS, 0)
    bad = []
    t0 = time.time()
    for path in files:
        green, counts, crashed = run_segment(path, extra, log, cwd)
        if not green and crashed:
            note = f"        segment died on a signal, run once more: {path}"
            print(note, flush=True)
            log.write(note + "\n")
            green, counts, crashed = run_segment(path, extra, log, cwd)
        for k in total:
            total[k] += counts[k]
        if not green:
            bad.append(path)
    verdict = "GREEN" if not bad else f"RED ({len(bad)} segment(s) failed)"
    summary = (f"full_gate {verdict}: {total['passed']} passed, "
               f"{total['failed']} failed, {total['errors']} errors, "
               f"{total['skipped']} skipped in {time.time() - t0:.0f}s"
               + (f"\n  failing: {', '.join(bad)}" if bad else ""))
    print(summary, flush=True)
    log.write(summary + "\n")
    return not bad, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", default=None,
                    help="also write the gate's lines and each failing "
                         "segment's output to this file")
    ap.add_argument("--files", nargs="*", default=None,
                    help="the test files (default: every tests/test_*.py)")
    ap.add_argument("-m", dest="markers", default=TIER1_MARKERS,
                    help=f"pytest's marker expression (default "
                         f"{TIER1_MARKERS!r}, the tier-1 tests)")
    ap.add_argument("pytest_args", nargs="*", default=[],
                    help="more arguments for every pytest segment")
    args = ap.parse_args(argv)
    files = args.files or sorted(
        str(f.relative_to(REPO)) for f in (REPO / "tests").glob("test_*.py"))
    extra = ["-m", args.markers, *args.pytest_args]
    head = (f"full_gate: {len(files)} test files, -m {args.markers!r}, "
            f"python {sys.version.split()[0]}, started "
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}")
    print(head, flush=True)
    with open(args.log or os.devnull, "w") as log:
        log.write(head + "\n")
        green, _ = gate(files, extra, log)
    return 0 if green else 1


if __name__ == "__main__":
    sys.exit(main())
