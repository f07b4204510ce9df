"""Design variants of the port's Hopper kernels, timed on one NVIDIA GPU.

    python3 profile_variants.py [--out DIR] [--only NAME ...]
                                [--baseline-source FILE.cu]

Each variant is a checked-in source (``csrc/apply_kernel.cu``,
``csrc/pack_kernel.cu`` or ``csrc/block_pack_kernel.cu``) with a few of its
lines replaced, built like the shipped library into ``_build/variants/``:

- apply: the 65536-entry code table read from L2 through ``__ldg``, where
  the shipped kernel copies it into shared memory;
- pack: the blocks of a tile coded in stream order, where the shipped kernel
  codes them in order of their nonzero counts; 1 or 2 nonzeros of a block
  coded together (``kUnroll``, 4 as shipped); a block's slot in shared
  memory of 8 or 24 words (``kSlotWords``, 16 as shipped);
- slot packs (the block pack and the tile pack): 8 warps a CTA with one
  group each in shared memory, or 2 warps a CTA with two (``kPackWarps``
  4 and ``kStages`` 2 as shipped); a tile split over clusters of 8 CTAs of
  256 blocks (``kSub`` 128, clusters of 16, as shipped); a block's slot
  walk with 6 of its 18 steps unrolled (fully unrolled as shipped);
  ``--baseline-source`` adds another ``block_pack_kernel.cu`` as a whole,
  for instance a parent commit's from a ``git archive``.

Inputs are a 4K request's own: ``testing.photo_p010(3840, 2160)`` encoded
with ``UhdrEncoder(device="cuda")`` in the library's default configuration
(map scale 1, 3-channel map); the pack gets the encode's two scans as one
stream, the apply the decode's stage outputs (SDR YUV and the upsampled
gain), to HLG, PQ and LINEAR, and the slot packs the slots of the same
scans (``testing.scans_slots``) in both configurations (the benchmark's:
map scale 4, 1-channel map), the tile pack at its default budget.  Every
variant's output must equal the plain version's (torch.equal; the tile
pack on its block lengths and live prefixes), or the script fails.  Times
are CUDA events in turns (shipped, variants..., variants reversed,
shipped), 20 launches a turn: the apply wrapper's launch, and the pack
kernels alone (``testing.pack_kernel_ms``, ``slot_pack_kernel_ms``)
beside their wrappers.  Prints a line per time with the card's name and
power limit (nvidia-smi) and writes DIR/kernel_variants.json.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import _buildlib, fused, jpegr, testing
from libultrahdr_tpu_torch.jpeg import device_entropy
from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
from libultrahdr_tpu_torch.ops import apply as apply_ops
from libultrahdr_tpu_torch.ops import apply_kernel as ak
from libultrahdr_tpu_torch.ops import idw

W, H = 3840, 2160
REPS = 20
# family -> (module, its library attribute, {variant: [(shipped text, its
# text)]})
VARIANTS = {
    "apply": (ak, "APPLY_LIB", {"code table from L2 (__ldg)": [
        ("(ct != kLinear ? kCodeBytes : 0)", "0"),
        ("  if (kCt != kLinear) copy_table(code, code_g, kCodeBytes);\n", ""),
        ("t.code = code;", "t.code = code_g;"),
        ("code = t.code[static_cast<int>(lut_index<kCodeN>(v))];",
         "code = __ldg(t.code + static_cast<int>(lut_index<kCodeN>(v)));")]}),
    "pack": (pk, "PACK_LIB", {
        "blocks in stream order": [
            ("const int cb = block_by_count(sm, b, nb, nnz);",
             "const int cb = b;")],
        "1 nonzero at a time": [("constexpr int kUnroll = 4;",
                                 "constexpr int kUnroll = 1;")],
        "2 nonzeros at a time": [("constexpr int kUnroll = 4;",
                                  "constexpr int kUnroll = 2;")],
        "8-word slots": [("constexpr int kSlotWords = 16;",
                          "constexpr int kSlotWords = 8;")],
        "24-word slots": [("constexpr int kSlotWords = 16;",
                           "constexpr int kSlotWords = 24;")]}),
    "slot packs": (pk, "BLOCK_PACK_LIB", {
        "block pack 8 warps, 1 stage": [
            ("constexpr int kPackWarps = 4;", "constexpr int kPackWarps = 8;"),
            ("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
        "block pack 2 warps a CTA": [
            ("constexpr int kPackWarps = 4;",
             "constexpr int kPackWarps = 2;")],
        "tile pack clusters of 8 x 256 blocks": [
            ("constexpr int kSub = 128;", "constexpr int kSub = 256;")],
        "slot walk 6 of 18 steps unrolled": [
            ("#pragma unroll\n  for (int i = 0; i < kSlots / 4; ++i) {\n"
             "    const int4 p = p4[i];",
             "#pragma unroll 6\n  for (int i = 0; i < kSlots / 4; ++i) {\n"
             "    const int4 p = p4[i];")]}),
}


def variant_lib(base: _buildlib.CudaLibrary, name: str, edits,
                source: str | None = None):
    """`base`'s library with each (shipped, text) of `edits` replaced in its
    source (each shipped text must occur once), or built from `source`."""
    src = base.source.read_text() if source is None else source
    for shipped, text in edits:
        if src.count(shipped) != 1:
            raise SystemExit(f"{base.source.name}: {shipped!r} not found once")
        src = src.replace(shipped, text)
    d = _buildlib.BUILD_DIR / "variants"
    d.mkdir(parents=True, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    path = d / f"{base.name}_{tag}.cu"
    path.write_text(src)
    lib = _buildlib.CudaLibrary(f"{base.name}_{tag}", base.signatures)
    lib.source = path
    return lib


def events_ms(fn, reps: int = REPS) -> float:
    """Mean ms of fn() over reps runs, one CUDA event pair around the
    whole loop, after one warm-up run."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def p010_scans(img, dev: torch.device, scale: int, multichannel: bool):
    """The base and gain-map scans [(coefficient planes, layout), ...] of a
    P010 request on the card."""
    return fused._api0_p010_block_buffers(
        *fused.upload_p010(img, dev), cg=port.ColorGamut.BT2100,
        ct=port.ColorTransfer.HLG, rng=port.ColorRange.FULL, scale=scale,
        multichannel=multichannel, gamma=1.0, quality=95, map_quality=95,
        use_base_cg=False)


def inputs(dev: torch.device):
    """(pack stream inputs, apply inputs per output) of one default-
    configuration 4K request, and the slot-pack inputs (pays, lens, budget)
    of both configurations."""
    img = testing.photo_p010(W, H)
    enc = port.UhdrEncoder(device="cuda")
    enc.set_raw_image(img, port.ImgLabel.HDR)
    enc.set_quality(95, port.ImgLabel.BASE)
    data = enc.encode()
    scans = p010_scans(img, dev, 1, True)
    pack_ins = [torch.cat(p) for p in zip(*(
        device_entropy.stream_inputs(c, lay) for c, lay in scans))]
    slot_ins = {}
    for cfg, scs in (("default", scans),
                     ("benchmark", p010_scans(img, dev, 4, False))):
        pays, lens = testing.scans_slots(scs)
        slot_ins[cfg] = (pays, lens,
                         device_entropy._default_budget(pays.shape[0]))

    jr = port.JpegR(device=dev)
    primary, pinfo, gm_jpeg, gm_info, md, sdr_cg, gm_cg = \
        jr._parse_jpegr(data, port.ColorTransfer.HLG)
    base = fused.decode_coefficients(primary, pinfo)
    gmap = fused.decode_coefficients(gm_jpeg, gm_info)
    scale_k = W // gm_info.width
    sdr, gm_u8 = fused._decode_sdr_and_gain(
        fused.upload_coeff_planes(base[0], dev), base[1],
        fused.upload_coeff_planes(gmap[0], dev), gmap[1], h=H, w=W,
        sampling_key="420", gm_channels=gm_info.num_components,
        scale_k=scale_k)
    gain = idw.idw_upsample(apply_ops._gain_to_float(gm_u8), scale_k, H,
                            W).contiguous()
    rows = ak.meta_to_rows(apply_ops.metadata_to_arrays(md))
    weight = np.float32(apply_ops.gainmap_weight(
        jpegr.FLT_MAX, float(md.hdr_capacity_min),
        float(md.hdr_capacity_max)))
    apply_ins = {ct.name: ((sdr, gain, rows, weight), dict(
        out_ct=ct, sdr_cg=port.ColorGamut(sdr_cg),
        hdr_cg=port.ColorGamut(gm_cg), use_base_cg=bool(md.use_base_cg)))
        for ct in (port.ColorTransfer.HLG, port.ColorTransfer.PQ,
                   port.ColorTransfer.LINEAR)}
    return pack_ins, apply_ins, slot_ins


def live_prefixes(tiles, blen):
    """The tile pack's defined output: blen and every tile's live words."""
    return blen, pk.stitch_tiles([(tiles, pk.tile_live_words(blen))])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--only", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS), help="kernel families to time")
    ap.add_argument("--baseline-source", type=pathlib.Path,
                    help="another block_pack_kernel.cu to time as a whole "
                         "beside the slot packs' variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_variants: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    pack_ins, apply_ins, slot_ins = inputs(dev)
    want = {}
    if "pack" in args.only:
        want["pack"] = pk.pack_scan_plain(*pack_ins)
    if "apply" in args.only:
        want["apply"] = {k: ak.apply_gainmap_plain(*a, **kw)
                         for k, (a, kw) in apply_ins.items()}
    if "slot packs" in args.only:
        want["slot packs"] = {
            cfg: (pk.pack_blocks_plain(pays, lens),
                  live_prefixes(*pk.pack_tiles_plain(pays, lens, budget)))
            for cfg, (pays, lens, budget) in slot_ins.items()}

    libs = {}
    for family in args.only:
        mod, attr, lines = VARIANTS[family]
        base = getattr(mod, attr)
        libs[family] = {"shipped": base} | {
            name: variant_lib(base, name, edits)
            for name, edits in lines.items()}
        if family == "slot packs" and args.baseline_source:
            libs[family]["baseline"] = variant_lib(
                base, "baseline", [], args.baseline_source.read_text())
        for lib in libs[family].values():
            lib.build()

    def measure(family, lib) -> dict:
        mod, attr, _ = VARIANTS[family]
        setattr(mod, attr, lib)
        if family == "pack":
            got = pk.pack_scan(*pack_ins)
            if not all(torch.equal(a, b)
                       for a, b in zip(got, want["pack"])):
                raise AssertionError(f"pack {lib.name} != plain")
            return {"kernel": testing.pack_kernel_ms(pack_ins),
                    "wrapper": events_ms(lambda: pk.pack_scan(*pack_ins))}
        out = {}
        if family == "apply":
            for k, (a, kw) in apply_ins.items():
                if not torch.equal(ak.APPLY_KERNEL(*a, **kw),
                                   want["apply"][k]):
                    raise AssertionError(f"apply {lib.name} {k} != plain")
                out[k] = events_ms(lambda: ak.APPLY_KERNEL(*a, **kw))
            return out
        for cfg, (pays, lens, budget) in slot_ins.items():
            blocks, tiles = want["slot packs"][cfg]
            got = (pk.PACK_BLOCKS_KERNEL(pays, lens), live_prefixes(
                *pk.PACK_TILES_KERNEL(pays, lens, budget)))
            for name, g, w in zip(("block pack", "tile pack"), got,
                                  (blocks, tiles)):
                if not all(torch.equal(a, b) for a, b in zip(g, w)):
                    raise AssertionError(f"{name} {lib.name} {cfg} != "
                                         "plain")
            for name, kern, extra in (
                    ("block pack", pk.PACK_BLOCKS_KERNEL, ()),
                    ("tile pack", pk.PACK_TILES_KERNEL, (budget,))):
                out[f"{name} {cfg}"] = {
                    "kernel": testing.slot_pack_kernel_ms(kern, pays, lens,
                                                          *extra),
                    "wrapper": events_ms(lambda: kern(pays, lens, *extra))}
        return out

    results = {}
    for family, named in libs.items():
        order = list(named) + list(named)[::-1]
        runs = {name: [] for name in named}
        for name in order:
            runs[name].append(measure(family, named[name]))
        mod, attr, _ = VARIANTS[family]
        setattr(mod, attr, named["shipped"])
        for name, rs in runs.items():
            key = f"{family}: {name}"
            results[key] = rs
            print(f"{key}: {rs} ms | {card}", flush=True)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel_variants.json").write_text(json.dumps(
        {"card": card, "blocks": int(pack_ins[0].shape[0]),
         "slot_pack_blocks": {cfg: int(v[0].shape[0])
                              for cfg, v in slot_ins.items()},
         "ptxas": {f"{family}: {name}": [
             ln.strip() for ln in lib.build_log.splitlines()
             if "entry function" in ln or "registers" in ln]
             for family, named in libs.items()
             for name, lib in named.items()},
         "ms": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
