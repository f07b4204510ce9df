"""Differential fuzzing of the port's decode: one device against another.

    python -m libultrahdr_tpu_torch.fuzz.differential [--execs N]
        [--seed S] [--device cuda] [--reference-device cpu]

Seeded mutants of small JPEG_R files that the port encodes on the CPU (a
96x48 file at map scale 2, and a 256x128 one at map scale 4 with a
3-channel map, so that the IDW and the map's YCbCr -> RGB run), plus the
committed ``corpus/probe/`` files, are decoded through
``UhdrDecoder(device=...)`` on `device` (the card unless the caller asks
for another) and on `reference_device` (the CPU), to HLG RGBA1010102 and
to LINEAR RGBAF16.  The gate, for every mutant and output:

* both devices give the same verdict: an output, or a coded ``UhdrError``;
  any other exception (``torch.AcceleratorError``, a ``RuntimeError`` of
  CUDA, an ``IndexError`` ...) is a crash;
* an accepted output is within the decode contract of the reference's
  (``testing.check_decoded_close``).

Half the mutants are light: 1-3 bit flips past the first 600 bytes, which
mostly still decode, so that the output check has teeth; the other half
come from the fuzzer's mutation stack (``fuzz_parsers.mutate``).

The decodes run in a child process, which writes each mutant to its work
directory before it decodes it: a CUDA fault poisons the context for the
rest of a process, so the parent must be able to name the input and keep
its bytes.  Every input at fault goes to ``crashes/`` (git-ignored) beside
``fuzz_parsers.py``.  Exit 0 when the gate holds for every mutant.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from .fuzz_parsers import CRASHES, PKG_DIR, _tag, corpus_files, mutate, \
    seed_stream

HLG_LINEAR = ("HLG", "LINEAR")


def make_seeds() -> list[bytes]:
    """The two seed files (CPU encodes) and the committed probe corpus."""
    return [seed_stream(96, 48, seed=9, scale=2),
            seed_stream(256, 128, seed=9, scale=4, multichannel=True)] \
        + corpus_files("probe")


def mutants(corpus: list[bytes], execs: int, seed: int):
    """(index, bytes) of `execs` seeded mutants: the seeds themselves
    first, then light and stacked mutants in turns."""
    rs = np.random.RandomState(seed)
    n_seeds = min(2, len(corpus))

    def light():
        d = bytearray(corpus[rs.randint(n_seeds)])
        for _ in range(rs.randint(1, 4)):
            d[rs.randint(600, len(d) - 2)] ^= 1 << rs.randint(8)
        return bytes(d)

    for i in range(execs):
        if i < n_seeds:
            yield i, corpus[i]
        else:
            yield i, light() if i % 2 else mutate(rs, corpus)


def decode(data: bytes, device, ct_name: str):
    """(packed host output, None), (None, UhdrError) for a coded reject;
    any other exception propagates."""
    from .. import testing
    from ..api import UhdrDecoder
    from ..errors import UhdrError
    from ..types import ColorTransfer, ImgFmt
    ct = ColorTransfer[ct_name]
    dec = UhdrDecoder(device=device)
    try:
        dec.set_image(data)
        dec.set_out_img_format(ImgFmt.RGBA1010102 if ct != ColorTransfer.LINEAR
                               else ImgFmt.RGBAF16)
        dec.set_out_color_transfer(ct)
        out = dec.decode()
    except UhdrError as e:
        return None, e
    return testing.host_packed(out.planes[0]), None


def compare(data: bytes, device, reference_device) -> tuple[list, bool]:
    """The gate on one input: (what differs, [] when both devices agree
    for both outputs; whether the reference accepted the HLG output).  A
    crash propagates."""
    from .. import testing
    from ..types import ColorTransfer
    faults = []
    accepted = False
    for ct in HLG_LINEAR:
        got, got_e = decode(data, device, ct)
        want, want_e = decode(data, reference_device, ct)
        if (got is None) != (want is None):
            faults.append(f"{ct}: {device} "
                          f"{'accepts' if got is not None else got_e}, "
                          f"{reference_device} "
                          f"{'accepts' if want is not None else want_e}")
        elif got is not None:
            try:
                testing.check_decoded_close(got, want, ColorTransfer[ct], ct)
            except AssertionError as e:
                faults.append(f"{ct}: outside the decode contract: {e}")
        accepted |= ct == "HLG" and want is not None
    return faults, accepted


def child(work: pathlib.Path, execs: int, seed: int, device,
          reference_device) -> int:
    """The decode loop: writes ``current`` (the mutant about to be decoded,
    with its index in ``current.idx``) before each decode, a line of
    ``faults.jsonl`` for each mutant the gate refuses, and ``summary.json``
    at the end."""
    from ..jpegr import resolve_device
    from ..tools.sanitize_kernels import launch_counts
    resolve_device(device), resolve_device(reference_device)
    corpus = make_seeds()
    before = launch_counts()
    accepted = n_faults = 0
    t0 = time.perf_counter()
    with open(work / "faults.jsonl", "w") as flog:
        for i, data in mutants(corpus, execs, seed):
            (work / "current").write_bytes(data)
            (work / "current.idx").write_text(str(i))
            faults, ok = compare(data, device, reference_device)
            accepted += ok
            if faults:
                n_faults += 1
                flog.write(json.dumps({"index": i, "tag": _tag(data),
                                       "faults": faults}) + "\n")
                flog.flush()
                (work / f"fault-{i}").write_bytes(data)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    (work / "summary.json").write_text(json.dumps({
        "execs": execs, "seed": seed, "device": str(device),
        "reference_device": str(reference_device), "accepted": accepted,
        "rejected": execs - accepted, "faults": n_faults, "seconds": seconds,
        "ms_per_mutant": 1e3 * seconds / max(execs, 1),
        "launches": {k: after[k] - before[k] for k in after}}))
    return 1 if n_faults else 0


def run(execs: int = 2000, seed: int = 0, device="cuda",
        reference_device="cpu", timeout: float | None = None,
        env: dict | None = None) -> dict:
    """Run the loop in a child process; returns ``collect``'s summary."""
    with tempfile.TemporaryDirectory(prefix="uhdr-diff-") as tmp:
        work = pathlib.Path(tmp)
        proc = subprocess.run(
            [sys.executable, "-m", "libultrahdr_tpu_torch.fuzz.differential",
             "--child", str(work), "--execs", str(execs), "--seed",
             str(seed), "--device", str(device), "--reference-device",
             str(reference_device)],
            cwd=PKG_DIR.parent, env=env, capture_output=True, text=True,
            timeout=timeout)
        summary = collect(work, proc.returncode)
        summary["stderr"] = proc.stderr[-4000:]
        return summary


def collect(work: pathlib.Path, returncode: int) -> dict:
    """What a child left in `work`: its summary (or, when it died, the
    mutant it was decoding as "crash", its index), "faults_seen" (the
    mutants the gate refused), "saved" (every input at fault, kept under
    ``crashes/``), "returncode" and "ok" (the child ended, exited 0 and no
    mutant was refused)."""
    summary_file = work / "summary.json"
    ended = summary_file.exists()
    summary = json.loads(summary_file.read_text()) if ended else {}
    faults = [json.loads(line) for line in
              (work / "faults.jsonl").read_text().splitlines()] \
        if (work / "faults.jsonl").exists() else []
    saved = [_keep(f"diff-{f['index']}-{f['tag']}",
                   (work / f"fault-{f['index']}").read_bytes())
             for f in faults]
    summary["crash"] = None
    if not ended and (work / "current").exists():
        data = (work / "current").read_bytes()
        summary["crash"] = int((work / "current.idx").read_text())
        saved.append(_keep(f"diff-crash-{summary['crash']}-{_tag(data)}",
                           data))
    summary.update(faults_seen=faults, saved=saved, returncode=returncode,
                   ok=ended and returncode == 0 and not faults)
    return summary


def _keep(name: str, data: bytes) -> str:
    CRASHES.mkdir(parents=True, exist_ok=True)
    (CRASHES / name).write_bytes(data)
    return str(CRASHES / name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libultrahdr_tpu_torch.fuzz.differential",
        description="the port's decode on one device against another on "
                    "seeded mutants")
    ap.add_argument("--execs", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device under test (default: the card)")
    ap.add_argument("--reference-device", default="cpu")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(pathlib.Path(args.child), args.execs, args.seed,
                     args.device, args.reference_device)
    from ..jpegr import resolve_device
    resolve_device(args.device)     # no card: raise here, not in the child
    summary = run(args.execs, args.seed, args.device, args.reference_device)
    print(f"{summary.get('execs')} mutants, {args.device} against "
          f"{args.reference_device}: accepted {summary.get('accepted')}, "
          f"rejected {summary.get('rejected')}, faults "
          f"{len(summary['faults_seen'])}, crash {summary['crash']}, "
          f"{summary.get('ms_per_mutant', float('nan')):.2f} ms a mutant")
    for f in summary["faults_seen"]:
        print(f"mutant {f['index']}: {'; '.join(f['faults'])}")
    if summary["saved"]:
        print("kept: " + ", ".join(summary["saved"]))
    if not summary["ok"]:
        print(summary["stderr"], file=sys.stderr)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
