"""What an Ultra HDR encode or decode of a configuration should give, and
the numbers that compare the program's outputs with it.

``encode_expectation`` works out, from the input planes alone, the
quantised coefficients of both JPEGs and the gain-map metadata that a
configuration's encode produces.  ``write_file`` writes those as a
phone-shaped file (baseline, Annex K tables, no restart markers, MPF with
XMP or ISO metadata); ``decode_expectation`` gives the 10-bit codes a
decode of such a file produces.  ``EncodeCheck`` and ``DecodeCheck`` read
the program's outputs and gather the compared numbers.

Nothing here imports the program.  ``dtype`` is float64 for the reference
and bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import color, container, jpeg

SAMPLING_420 = [(2, 2), (1, 1), (1, 1)]
SAMPLING_444 = [(1, 1), (1, 1), (1, 1)]


def _meta(cfg: dict, dtype, lo=None, hi=None) -> dict:
    """The gain-map metadata of an encode, each value computed in `dtype`:
    closed form for REALTIME, from the log2 bounds for BEST_QUALITY."""
    def f(x):
        return float(torch.as_tensor(x, dtype=torch.float64).to(dtype))
    peak = f(f(color.PEAK_NITS[cfg["hdr_transfer"]]) / f(color.SDR_WHITE))
    if cfg["preset"] == "REALTIME":
        return {"min_boost": [1.0] * 3, "max_boost": [peak] * 3,
                "gamma": [f(cfg["gamma"])] * 3, "offset_sdr": [0.0] * 3,
                "offset_hdr": [0.0] * 3, "hdr_capacity_min": 1.0,
                "hdr_capacity_max": peak}
    lo3 = [f(lo[min(c, len(lo) - 1)]) for c in range(3)]
    hi3 = [f(hi[min(c, len(hi) - 1)]) for c in range(3)]
    return {"min_boost": [f(2.0 ** v) for v in lo3],
            "max_boost": [f(2.0 ** v) for v in hi3],
            "gamma": [f(cfg["gamma"])] * 3, "offset_sdr": [f(1e-7)] * 3,
            "offset_hdr": [f(1e-7)] * 3, "hdr_capacity_min": 1.0,
            "hdr_capacity_max": peak}


def use_base_cg(cfg: dict, xmp: bool) -> bool:
    """The gain map's application gamut (jpegr.cpp:600-646): the base's
    where the two gamuts agree or XMP is written, else the HDR's for a
    BT.2100 HDR intent."""
    if cfg["hdr_gamut"] == "P3" or xmp:
        return True
    return cfg["hdr_gamut"] != "BT2100"


def sdr_rendition(y16, uv16, cfg: dict, dtype=torch.float64):
    """The YUV420 Display-P3 SDR that API-1 is given: the API-0 tone map
    of the HDR intent, as (Y, U, V) uint8 host planes."""
    hdr = color.unpack_p010(y16, uv16, dtype)
    return [p.to(torch.uint8).cpu().numpy() for p in color.tone_map_yuv420(
        hdr, cfg["hdr_gamut"], cfg["hdr_transfer"])]


def encode_expectation(cfg: dict, y16, uv16, sdr=None, *, xmp=False,
                       dtype=torch.float64) -> dict:
    """The encode of one request: {"base": [3 (bh, bw, 64) int64
    tensors], "map": [1 or 3 ...], "meta": metadata, "use_base_cg"}.
    y16, uv16: the P010 planes as tensors on the device to compute on;
    sdr: the API-1 SDR (Y, U, V) tensors, None for API-0."""
    hdr = color.unpack_p010(y16, uv16, dtype)
    if sdr is None:
        sy, su, sv = color.tone_map_yuv420(hdr, cfg["hdr_gamut"],
                                           cfg["hdr_transfer"])
    else:
        sy, su, sv = (p.to(torch.int64) for p in sdr)
    sdr_yuv = color.unpack_yuv420(sy, su, sv, dtype)
    ubc = use_base_cg(cfg, xmp)
    kw = dict(hdr_cg=cfg["hdr_gamut"], ct=cfg["hdr_transfer"],
              scale=cfg["map_scale"], use_base_cg=ubc,
              multichannel=cfg["multichannel_map"])
    if cfg["preset"] == "REALTIME":
        gm = color.gainmap_onepass(sdr_yuv, hdr, **kw)
        meta = _meta(cfg, dtype)
    else:
        gm, lo, hi = color.gainmap_twopass(sdr_yuv, hdr, **kw)
        meta = _meta(cfg, dtype, lo, hi)
    qb = [jpeg.quant_table(jpeg.LUMA_QUANT, cfg["base_quality"]),
          jpeg.quant_table(jpeg.CHROMA_QUANT, cfg["base_quality"])]
    qm = [jpeg.quant_table(jpeg.LUMA_QUANT, cfg["map_quality"]),
          jpeg.quant_table(jpeg.CHROMA_QUANT, cfg["map_quality"])]
    base = jpeg.quantised_planes([sy, su, sv], SAMPLING_420,
                                 [qb[0], qb[1], qb[1]], dtype)
    if gm.shape[0] == 3:
        ycc = jpeg.rgb_to_ycc(gm, dtype)
        mp = jpeg.quantised_planes(ycc, SAMPLING_444, [qm[0], qm[1], qm[1]],
                                   dtype)
    else:
        mp = jpeg.quantised_planes([gm[0]], [(1, 1)], [qm[0]], dtype)
    return {"base": base, "map": mp, "meta": meta, "use_base_cg": ubc,
            "qtables": (qb, qm), "map_channels": gm.shape[0]}


def write_file(cfg: dict, exp: dict, xmp: bool) -> bytes:
    """A phone-shaped Ultra HDR file of an encode expectation: baseline
    JPEGs with the Annex K tables and no restart markers, a Display-P3 ICC
    on the base, MPF, and XMP or ISO 21496-1 metadata on the gain map."""
    w, h, k = cfg["width"], cfg["height"], cfg["map_scale"]
    qb, qm = exp["qtables"]
    meta = exp["meta"]
    cap = meta["hdr_capacity_max"]
    if xmp:
        gm_app = [jpeg.segment(0xE1, container.xmp_secondary(meta, cap))]
    else:
        gm_app = [container.icc_segment(cfg["hdr_gamut"],
                                        cfg["hdr_transfer"]),
                  jpeg.segment(0xE2, container.iso_payload(
                      meta, cap, exp["use_base_cg"]))]
    n = exp["map_channels"]
    gm_jpeg = jpeg.write_jpeg(h // k, w // k, SAMPLING_444[:n]
                              if n == 3 else [(1, 1)], qm,
                              [c for c in exp["map"]], gm_app)
    base_app = [container.icc_segment("P3", "SRGB")]
    if xmp:
        base_app.insert(0, jpeg.segment(0xE1, container.xmp_primary(
            len(gm_jpeg))))
    else:
        base_app.append(jpeg.segment(0xE2, container.ISO_NS + bytes(4)))
    base_jpeg = jpeg.write_jpeg(h, w, SAMPLING_420, qb, exp["base"],
                                base_app)
    return container.assemble(base_jpeg, gm_jpeg)


def decode_expectation(cfg: dict, exp: dict, out_ct: str, *, xmp: bool,
                       dtype=torch.float64) -> torch.Tensor:
    """The (3, H, W) int64 10-bit codes a decode of ``write_file(cfg, exp,
    xmp)`` to `out_ct` gives: islow IDCT, chroma replicated, the map's
    YCbCr -> RGB, IDW at the map scale, the gain applied."""
    w, h, k = cfg["width"], cfg["height"], cfg["map_scale"]
    qb, qm = exp["qtables"]
    b = exp["base"]
    y = jpeg.idct_islow(b[0], qb[0], h, w)
    u = jpeg.idct_islow(b[1], qb[1], h // 2, w // 2)
    v = jpeg.idct_islow(b[2], qb[1], h // 2, w // 2)
    sdr = color.unpack_yuv420(y, u, v, dtype)
    m = exp["map"]
    if len(m) == 3:
        planes = [jpeg.idct_islow(c, qm[min(i, 1)], h // k, w // k)
                  for i, c in enumerate(m)]
        gm = jpeg.ycc_to_rgb(*planes)
    else:
        gm = jpeg.idct_islow(m[0], qm[0], h // k, w // k)[None]
    gain = color.idw_upsample(gm.to(dtype) / 255, k, h, w)
    ubc = exp["use_base_cg"]
    hdr_cg = "P3" if xmp else cfg["hdr_gamut"]
    return color.apply_gain(sdr, gain, exp["meta"], out_ct=out_ct,
                            sdr_cg="P3", hdr_cg=hdr_cg, use_base_cg=ubc)


def unpack_1010102(packed: np.ndarray) -> torch.Tensor:
    """(H, W) uint32 RGBA1010102 -> (3, H, W) int64 codes."""
    p = torch.from_numpy(packed.astype(np.int64))
    return torch.stack([(p >> s) & 1023 for s in (0, 10, 20)])


def coef_gap(got, want):
    """(widest gap, number of coefficients that differ, count) between
    lists of coefficient planes of equal shapes."""
    gap, diff, n = 0, 0, 0
    for g, w in zip(got, want):
        d = (torch.as_tensor(g).to(w.device) - w).abs()
        gap = max(gap, int(d.max()))
        diff += int((d > 0).sum())
        n += d.numel()
    return gap, diff, n


def meta_gap(got: dict, want: dict) -> float:
    """The widest gap of the metadata: boosts and capacities in log2, the
    gamma and the offsets as they are."""
    gaps = []
    for f in container.FIELDS:
        for c in range(3):
            a, b = got[f][c], want[f][c]
            if f.endswith("boost"):
                a, b = math.log2(a), math.log2(b)
            gaps.append(abs(a - b))
    for f in ("hdr_capacity_min", "hdr_capacity_max"):
        gaps.append(abs(math.log2(got[f]) - math.log2(want[f])))
    return max(gaps)


class Numbers:
    """The compared numbers of a run, each the worst over what was
    checked, and the faults found."""

    def __init__(self, names):
        self.values = {n: 0.0 for n in names}
        self.faults = []
        self.checked = 0

    def worst(self, name, value):
        self.values[name] = max(self.values[name], float(value))

    def fault(self, what: str):
        self.faults.append(what)

    def result(self):
        out = dict(self.values)
        out["faults"] = float(len(self.faults))
        return out


ENCODE_NUMBERS = ("base_gap", "base_diff_share", "map_gap",
                  "map_diff_share", "meta_gap")
DECODE_NUMBERS = ("out_gap", "out_diff_share")


def check_encode(outputs, expectations, cfg: dict) -> Numbers:
    """Compare encoded files with their expectations.  outputs: [(label,
    bytes, expectation key)]; expectations: key -> encode_expectation."""
    nums = Numbers(ENCODE_NUMBERS)
    parsed = []
    for label, data, key in outputs:
        try:
            primary, gm = container.split(data)
            pb, pg = jpeg.parse_jpeg(primary), jpeg.parse_jpeg(gm)
            meta = container.gainmap_metadata(pg.app)
        except (ValueError, IndexError, KeyError) as e:
            nums.fault(f"{label}: container: {e}")
            continue
        exp = expectations[key]
        want_shape = [(cfg["height"], cfg["width"]),
                      (cfg["height"] // cfg["map_scale"],
                       cfg["width"] // cfg["map_scale"])]
        got_shape = [(pb.h, pb.w), (pg.h, pg.w)]
        if got_shape != want_shape or len(pb.comps) != 3 \
                or len(pg.comps) != exp["map_channels"]:
            nums.fault(f"{label}: shapes {got_shape}, components "
                       f"{len(pb.comps)}/{len(pg.comps)}")
            continue
        qb, qm = exp["qtables"]
        if not (np.array_equal(pb.qt.get(0), qb[0])
                and np.array_equal(pb.qt.get(1), qb[1])
                and np.array_equal(pg.qt.get(0), qm[0])):
            nums.fault(f"{label}: quantisation tables")
            continue
        if bool(meta["use_base_cg"]) != bool(exp["use_base_cg"]):
            nums.fault(f"{label}: use_base_cg {meta['use_base_cg']}")
            continue
        nums.worst("meta_gap", meta_gap(meta, exp["meta"]))
        parsed.append((label, key, pb, pg))
    decoded = jpeg.huffman_decode([p for _, _, pb, pg in parsed
                                   for p in (pb, pg)])
    for i, (label, key, _, _) in enumerate(parsed):
        exp = expectations[key]
        for part, got in (("base", decoded[2 * i]),
                          ("map", decoded[2 * i + 1])):
            if isinstance(got, str):
                nums.fault(f"{label}: {part} scan: {got}")
                continue
            shapes = [tuple(g.shape) for g in got]
            if shapes != [tuple(w.shape) for w in exp[part]]:
                nums.fault(f"{label}: {part} blocks {shapes}")
                continue
            gap, diff, n = coef_gap(got, exp[part])
            nums.worst(f"{part}_gap", gap)
            nums.worst(f"{part}_diff_share", diff / n)
        nums.checked += 1
    return nums


def check_decode(outputs, expectations) -> Numbers:
    """Compare decoded images with their expected codes.  outputs:
    [(label, (H, W) uint32 RGBA1010102 array, key)]; expectations: key ->
    (3, H, W) int64 codes."""
    nums = Numbers(DECODE_NUMBERS)
    for label, img, key in outputs:
        want = expectations[key]
        if img.shape != tuple(want.shape[1:]) or img.dtype != np.uint32:
            nums.fault(f"{label}: output {img.dtype} {img.shape}")
            continue
        if not np.all((img >> 30) == 3):
            nums.fault(f"{label}: alpha bits")
            continue
        got = unpack_1010102(img).to(want.device)
        d = (got - want).abs()
        nums.worst("out_gap", int(d.max()))
        nums.worst("out_diff_share", float((d > 0).double().mean()))
        nums.checked += 1
    return nums


def compare_expectations(got: dict, want: dict, kind: str) -> dict:
    """The compared numbers between two expectations of one request (the
    control's against the reference's): coefficients and metadata for an
    encode, output codes for a decode."""
    if kind == "decode":
        d = (got - want).abs()
        return {"out_gap": float(d.max()),
                "out_diff_share": float((d > 0).double().mean())}
    out = {"meta_gap": meta_gap(got["meta"], want["meta"])}
    for part in ("base", "map"):
        gap, diff, n = coef_gap(got[part], want[part])
        out[f"{part}_gap"] = float(gap)
        out[f"{part}_diff_share"] = diff / n
    return out
