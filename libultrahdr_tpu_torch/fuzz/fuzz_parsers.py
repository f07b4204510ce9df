"""Coverage-guided mutation fuzzer for the port's byte-stream parsers.

    python -m libultrahdr_tpu_torch.fuzz.fuzz_parsers [--target T]
        [--execs N] [--seed S] [--device cuda|cpu]

The port decodes untrusted files: the segment scanner, the ISO 21496-1,
XMP and ICC parsers, the JPEG header parser, the host Huffman decoders
(``jpeg/native.py`` over ``csrc/host/``) and the probe.  This module runs
the AFL loop over them in process:

* line coverage of each exec through ``sys.monitoring`` (PEP 669), scoped
  to the ``libultrahdr_tpu_torch`` package;
* a corpus (``corpus/<target>/`` beside this file) of inputs that each
  reached new lines, grown from valid inputs made in process: ISO, XMP and
  ICC blobs from the port's writers, and JPEG_R files (and their two JPEGs)
  from the port's encoder on the CPU;
* a mutation stack (bit flips, interesting bytes, truncation, splices,
  deletions, 16-bit length fields +-1 and +-256, cross-corpus splices)
  driven by a seeded numpy RNG;
* any exception outside ``CLEAN`` (``UhdrError``, and the ``ValueError``
  that struct-level helpers raise) is a crash: its input is written to
  ``crashes/`` (git-ignored) and the run exits 1.

``jpeg_decode`` decodes with the IDCT on ``--device`` (the card unless the
caller asks for the CPU) and ``probe`` runs ``JpegR(device=...).get_info``;
the other targets touch no device.  The seeds are always CPU encodes, so a
run on either device starts from the same bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys

import numpy as np

from ..errors import UhdrError

# exceptions that count as clean, coded rejections (the parsers raise
# UhdrError; struct-level helpers may surface ValueError)
CLEAN = (UhdrError, ValueError)

HERE = pathlib.Path(__file__).resolve().parent
PKG_DIR = HERE.parent
CORPUS = HERE / "corpus"
CRASHES = HERE / "crashes"
# the jpeg_decode target decodes images up to this many pixels
MAX_DECODE_PIXELS = 512 * 512


# ---------------------------------------------------------------------------
# targets: each takes (bytes, JpegR), returns anything, raises CLEAN on bad
# input; the JpegR carries the device

def target_scan(data: bytes, jr):
    from ..container.segments import scan_jpeg_images
    return scan_jpeg_images(data)


def target_iso(data: bytes, jr):
    from ..container.iso21496 import decode_gainmap_metadata
    return decode_gainmap_metadata(data)


def target_xmp(data: bytes, jr):
    from ..container.xmp import parse_xmp_metadata
    return parse_xmp_metadata(data)


def target_icc(data: bytes, jr):
    from ..container.icc import read_icc_color_gamut
    return read_icc_color_gamut(data)


def target_jpeg_parse(data: bytes, jr):
    from ..jpeg.decoder import parse_jpeg
    return parse_jpeg(data, parse_only=True)


def target_jpeg_decode(data: bytes, jr):
    """The header parse, the host Huffman decode (``native.decode_scan`` or
    the progressive decoder) and the IDCT on the JpegR's device, for images
    of at most MAX_DECODE_PIXELS."""
    from ..jpeg.decoder import decode_to_planes, parse_jpeg
    info = parse_jpeg(data)
    if info.width * info.height > MAX_DECODE_PIXELS:
        return None
    return decode_to_planes(data, info, device=jr.device)


def target_probe(data: bytes, jr):
    """The probe: ``is_uhdr_image`` and ``JpegR.get_info``."""
    from ..jpegr import is_uhdr_image
    is_uhdr_image(data)
    return jr.get_info(data)


TARGETS = {
    "scan": target_scan,
    "iso": target_iso,
    "xmp": target_xmp,
    "icc": target_icc,
    "jpeg_parse": target_jpeg_parse,
    "jpeg_decode": target_jpeg_decode,
    "probe": target_probe,
}


# ---------------------------------------------------------------------------
# seeds

def seed_metadata():
    """The gain-map metadata the ISO and XMP seeds are written from."""
    from ..types import GainMapMetadata
    md = GainMapMetadata()
    md.max_content_boost[:] = (4.0, 3.0, 5.0)
    md.min_content_boost[:] = 1.0
    md.gamma[:] = 1.0
    md.offset_sdr[:] = 1.0 / 64
    md.offset_hdr[:] = 1.0 / 64
    md.hdr_capacity_min, md.hdr_capacity_max = 1.0, 4.926
    return md


def seed_stream(w: int = 96, h: int = 48, seed: int = 7, scale: int = 2,
                multichannel: bool = False) -> bytes:
    """A JPEG_R file of seeded P010 noise (BT.2100 HLG, full range),
    encoded by the port on the CPU at quality 85."""
    from ..jpegr import JpegR
    from ..types import ColorGamut, ColorRange, ColorTransfer, ImgFmt, \
        RawImage
    rs = np.random.RandomState(seed)
    y = (rs.randint(0, 1024, (h, w)).astype(np.uint16) << 6)
    uv = (rs.randint(0, 1024, (h // 2, w)).astype(np.uint16) << 6)
    img = RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                   ColorRange.FULL, w, h, [y, uv])
    jr = JpegR(map_dimension_scale_factor=scale,
               use_multi_channel_gainmap=multichannel, device="cpu")
    return jr.encode_api0(img, quality=85)


def make_seeds(target: str) -> list[bytes]:
    """Valid inputs for `target`, made in process (no committed binaries
    needed; the corpus directory collects the interesting mutants)."""
    from ..container import icc as icc_mod
    from ..container import iso21496, xmp
    from ..types import ColorGamut, ColorTransfer

    md = seed_metadata()
    if target == "iso":
        seeds = []
        for mc in (False, True):
            for b in (False, True):
                md.use_base_cg = b
                if not mc:
                    md.max_content_boost[:] = 4.0
                frac = iso21496.float_to_fraction(md)
                seeds.append(iso21496.encode_gainmap_metadata(frac))
        return seeds
    if target == "xmp":
        return [xmp.generate_xmp_for_secondary_image(md).encode(),
                xmp.generate_xmp_for_primary_image(1234, md).encode()]
    if target == "icc":
        return [icc_mod.write_icc_profile(ct, cg)
                for ct in (ColorTransfer.SRGB, ColorTransfer.HLG,
                           ColorTransfer.PQ, ColorTransfer.LINEAR)
                for cg in (ColorGamut.BT709, ColorGamut.DISPLAY_P3,
                           ColorGamut.BT2100)]
    stream = seed_stream()
    if target in ("jpeg_parse", "jpeg_decode"):
        from ..container.segments import scan_jpeg_images
        return [stream[a:b] for a, b in scan_jpeg_images(stream)]
    return [stream]


def corpus_files(target: str) -> list[bytes]:
    """The committed corpus of `target`, in name order."""
    d = CORPUS / target
    return [f.read_bytes() for f in sorted(d.iterdir())] if d.is_dir() \
        else []


# ---------------------------------------------------------------------------
# coverage via sys.monitoring (PEP 669)

_TOOL = 3  # sys.monitoring tool id (0 debugger, 1 coverage, 2 profiler)


class Coverage:
    """Lines of the port's package reached by one exec, and by all."""

    def __init__(self):
        self.seen: set[tuple[int, int]] = set()
        self.current: set[tuple[int, int]] = set()
        self._pkg = str(PKG_DIR) + "/"
        mon = sys.monitoring
        mon.use_tool_id(_TOOL, "uhdr-torch-fuzz")
        mon.register_callback(_TOOL, mon.events.LINE, self._on_line)

    def _on_line(self, code, line):
        if code.co_filename.startswith(self._pkg):
            self.current.add((id(code), line))
        else:
            return sys.monitoring.DISABLE  # stop monitoring foreign code

    def run(self, fn, data: bytes, jr):
        """fn(data, jr) under line monitoring: (reached new lines, the
        exception outside CLEAN or None)."""
        mon = sys.monitoring
        self.current = set()
        mon.set_events(_TOOL, mon.events.LINE)
        try:
            fn(data, jr)
            exc = None
        except CLEAN:
            exc = None
        except Exception as e:  # noqa: BLE001 - crash triage is the point
            exc = e
        finally:
            mon.set_events(_TOOL, 0)
            mon.restart_events()
        new = self.current - self.seen
        self.seen |= self.current
        return bool(new), exc

    def close(self):
        mon = sys.monitoring
        mon.register_callback(_TOOL, mon.events.LINE, None)
        mon.free_tool_id(_TOOL)


# ---------------------------------------------------------------------------
# mutations

_INTERESTING = [0, 1, 0x7F, 0x80, 0xFF, 0xD8, 0xD9, 0xDA, 0xE0, 0xE1, 0xE2]


def mutate(rs: np.random.RandomState, corpus: list[bytes]) -> bytes:
    """One mutant of a corpus entry: 1-4 stacked byte-level operations."""
    base = bytearray(corpus[rs.randint(len(corpus))])
    if not base:
        return rs.bytes(rs.randint(1, 64))
    for _ in range(rs.randint(1, 5)):
        op = rs.randint(7)
        if op == 0:                                   # bit flip
            p = rs.randint(len(base))
            base[p] ^= 1 << rs.randint(8)
        elif op == 1:                                 # interesting byte
            base[rs.randint(len(base))] = _INTERESTING[
                rs.randint(len(_INTERESTING))]
        elif op == 2:                                 # truncate
            base = base[:rs.randint(1, len(base) + 1)]
        elif op == 3:                                 # splice random blob
            p = rs.randint(len(base) + 1)
            base = base[:p] + bytearray(rs.bytes(rs.randint(1, 32))) + base[p:]
        elif op == 4:                                 # delete span
            if len(base) > 4:
                p = rs.randint(len(base) - 2)
                base = base[:p] + base[p + rs.randint(1, min(16, len(base) - p)):]
        elif op == 5 and len(base) >= 2:              # 16-bit length +-1
            p = rs.randint(len(base) - 1)
            v = (base[p] << 8) | base[p + 1]
            v = (v + rs.choice([-1, 1, 0x100, -0x100])) & 0xFFFF
            base[p], base[p + 1] = v >> 8, v & 0xFF
        elif op == 6 and len(corpus) > 1:             # cross-corpus splice
            other = corpus[rs.randint(len(corpus))]
            if other:
                p = rs.randint(len(base) + 1)
                q0 = rs.randint(len(other))
                q1 = min(len(other), q0 + rs.randint(1, 64))
                base = base[:p] + bytearray(other[q0:q1]) + base[p:]
    return bytes(base)


# ---------------------------------------------------------------------------

def _tag(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()[:12]


def fuzz_target(name: str, execs: int, seed: int = 0, device="cuda",
                save_corpus: bool = True) -> list[tuple[bytes, Exception]]:
    """`execs` guided execs of target `name` on `device`; returns the
    crashes (input, exception), each also written to ``crashes/``."""
    from ..jpegr import JpegR
    jr = JpegR(device=device)   # a CUDA request without a card raises here
    fn = TARGETS[name]
    rs = np.random.RandomState(seed)
    corpus_dir = CORPUS / name
    corpus = make_seeds(name) + corpus_files(name)

    cov = Coverage()
    crashes = []

    def crash(data, exc):
        crashes.append((data, exc))
        CRASHES.mkdir(parents=True, exist_ok=True)
        (CRASHES / f"{name}-{_tag(data)}").write_bytes(data)
        print(f"[{name}] CRASH {type(exc).__name__}: {exc} -> "
              f"crashes/{name}-{_tag(data)}", flush=True)

    try:
        # warm the coverage map (and the lazy imports) on the seeds
        for s in corpus:
            _, exc = cov.run(fn, s, jr)
            if exc is not None:
                crash(s, exc)
        for _ in range(execs):
            data = mutate(rs, corpus)
            new, exc = cov.run(fn, data, jr)
            if exc is not None:
                crash(data, exc)
            elif new:
                corpus.append(data)
                if save_corpus:
                    corpus_dir.mkdir(parents=True, exist_ok=True)
                    (corpus_dir / _tag(data)).write_bytes(data)
    finally:
        cov.close()
    return crashes


def minimize(name: str, device="cuda") -> tuple[int, int]:
    """Drop the corpus files of `name` that reach no line the seeds and
    the smaller files before them do not (smallest first); returns (files
    before, files kept)."""
    from ..jpegr import JpegR
    jr = JpegR(device=device)
    fn = TARGETS[name]
    files = sorted((CORPUS / name).iterdir(),
                   key=lambda f: (f.stat().st_size, f.name)) \
        if (CORPUS / name).is_dir() else []
    cov = Coverage()
    try:
        for s in make_seeds(name):
            cov.run(fn, s, jr)
        kept = 0
        for f in files:
            new, _ = cov.run(fn, f.read_bytes(), jr)
            if new:
                kept += 1
            else:
                f.unlink()
    finally:
        cov.close()
    return len(files), kept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libultrahdr_tpu_torch.fuzz.fuzz_parsers",
        description="coverage-guided fuzzing of the port's parsers")
    ap.add_argument("--target", choices=sorted(TARGETS), default=None,
                    help="one target (default: all seven)")
    ap.add_argument("--execs", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode and probe targets "
                         "(default: the card)")
    ap.add_argument("--no-save", action="store_true",
                    help="keep the corpus directory as it is")
    ap.add_argument("--minimize", action="store_true",
                    help="only drop the corpus files that add no coverage")
    args = ap.parse_args(argv)
    names = [args.target] if args.target else sorted(TARGETS)
    total = 0
    for name in names:
        if args.minimize:
            before, kept = minimize(name, args.device)
            print(f"[{name}] kept {kept} of {before} corpus files")
            continue
        crashes = fuzz_target(name, args.execs, args.seed, args.device,
                              save_corpus=not args.no_save)
        print(f"[{name}] {args.execs} execs on {args.device}, "
              f"{len(crashes)} crashes", flush=True)
        total += len(crashes)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
