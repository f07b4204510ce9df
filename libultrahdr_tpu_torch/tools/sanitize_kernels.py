"""Every hand-written CUDA kernel of the port, through its wrapper, held
torch.equal to its plain PyTorch version: the program that phase 20 of
chip_smoke.py runs under compute-sanitizer, and under this module's own
guards where the sanitizer cannot attach.

    python -m libultrahdr_tpu_torch.tools.sanitize_kernels --tool T
    python -m libultrahdr_tpu_torch.tools.sanitize_kernels --guard right
        [--fill 0xA5]
    python -m libultrahdr_tpu_torch.tools.sanitize_kernels --repeat N

The nine kernels (``KERNELS``): the scan pack (``csrc/pack_kernel.cu``),
the block and tile packs (``csrc/block_pack_kernel.cu``), the apply's
HLG/PQ and LINEAR branches (``csrc/apply_kernel.cu``), the scan build
(``csrc/dct_kernel.cu``), the wire un-slice and the download pack
(``csrc/wire_kernel.cu``) and the K-batch stitch
(``csrc/stitch_kernel.cu``).  Their cases are chip_smoke's phase 3, 18a
and 22 edge cases ("small": one MCU, MCU grids with ragged edges, block
counts on and off the packs' tiles, an overflowing tile, worst-case
blocks, grid ties, NaN and out-of-range values, 2-8-bit wires, escape
lists at and over their cap, ``testing.stitch_edge_cases``) and the 4K
default shapes ("4k": the 3840x2160 base and 3-channel map scans, 583,200
blocks in one pack, the 4K apply, wires of 8,294,400 samples, a stitch of
8 images' rooms of 583,200 blocks).  A stitch is compared on its live
words, the words its output defines.

``--tool T`` (memcheck, racecheck, synccheck, initcheck: the process runs
under ``compute-sanitizer --tool T``) runs the small cases, memcheck also
the 4K ones; run it with ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, so that each
tensor is an allocation of its own that the sanitizer can bound.

``--guard right|left`` installs ``guard_alloc.cpp`` as PyTorch's allocator
before the first CUDA allocation: every tensor gets a mapping of its own
that ends (right) or starts (left) at an unmapped granule of address
space, filled with ``--fill`` first, so an access past either end faults
and a read of memory no one wrote shows as a difference between two fills.
It runs the small and the 4K cases.  ``--repeat N`` runs every small case
N times while another stream keeps the card busy, each result equal to the
first: a stress of the packs' cross-CTA protocols (the look-back, the
cluster's distributed shared memory), not a race detector.

The last line of the output is one JSON object: per kernel its cases,
launches and seconds.  Exit 0 when every output equals its plain version.
Runs only on the card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
KERNELS = ("pack_scan", "pack_blocks", "pack_tiles", "apply_gainmap",
           "apply_gainmap_linear", "forward_dct", "wire_unslice",
           "down_pack", "stitch")


def tensors_equal(got, want, what: str):
    """Every output tensor torch.equal to the plain version's."""
    import torch
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the plain "
                                 f"version ({a.dtype} {tuple(a.shape)} vs "
                                 f"{b.dtype} {tuple(b.shape)})")


def tiles_equal(got, want, what: str):
    """The tile pack's (tiles, blen): blen and every tile's live prefix
    (the rest of a tile is undefined)."""
    from ..jpeg import pack_kernel as pk
    (gt, gb), (wt, wb) = got, want
    if gt.shape != wt.shape:
        raise AssertionError(f"{what}: tiles {tuple(gt.shape)} vs "
                             f"{tuple(wt.shape)}")
    live = pk.tile_live_words(wb)
    tensors_equal((gb, pk.stitch_tiles([(gt, live)])),
                  (wb, pk.stitch_tiles([(wt, live)])), what)


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# ---------------------------------------------------------------------------
# the cases: (kernel, what, run the wrapper, run the plain version, compare)

def _pack_cases(dev, big: bool):
    import torch
    from .. import testing
    from ..jpeg import device_entropy, pack_kernel as pk
    eq = tensors_equal
    grids = ((((2, 2), (1, 1), (1, 1)), 1, 1), (((2, 2), (1, 1), (1, 1)),
                                                 24, 16),
             (((1, 1), (1, 1), (1, 1)), 37, 21), (((1, 1),), 61, 45))
    if big:     # the 4K default request: base 4:2:0 and 3-channel map
        grids = ((((2, 2), (1, 1), (1, 1)), 240, 135),
                 (((1, 1), (1, 1), (1, 1)), 480, 270))
    ins_all = []
    for sampling, mw, mh in grids:
        layout = device_entropy.scan_layout(sampling, mw, mh)
        planes = [torch.from_numpy(p).to(dev)
                  for p in testing.coefficient_planes(layout, seed=mw)]
        ins = device_entropy.stream_inputs(planes, layout)
        ins_all.append(ins)
        what = f"{sampling} {mw}x{mh} MCUs"
        if not big:
            yield ("pack_scan", what, lambda ins=ins: pk.pack_scan(*ins),
                   lambda ins=ins: pk.pack_scan_plain(*ins), eq)
        pays, lens = pk.slots_for_kernel(planes, layout)
        yield ("pack_blocks", what,
               lambda p=pays, n=lens: pk.pack_blocks(p, n),
               lambda p=pays, n=lens: pk.pack_blocks_plain(p, n), eq)
        yield ("pack_tiles", what,
               lambda p=pays, n=lens: pk.pack_tiles(p, n, 16),
               lambda p=pays, n=lens: pk.pack_tiles_plain(p, n, 16),
               tiles_equal)
    if big:     # both scans in one launch, as the encode packs them
        ins = tuple(torch.cat(parts) for parts in zip(*ins_all))
        yield ("pack_scan", f"both 4K scans, {ins[0].shape[0]} blocks",
               lambda: pk.pack_scan(*ins), lambda: pk.pack_scan_plain(*ins),
               eq)
        return
    # blocks at the pack kernel's word cap, 40 times over (320 blocks)
    worst = [t.repeat(40, *([1] * (t.dim() - 1))).contiguous().to(dev)
             for t in testing.pack_worst_case_stream()]
    yield ("pack_scan", "320 worst-case blocks",
           lambda: pk.pack_scan(*worst), lambda: pk.pack_scan_plain(*worst),
           eq)
    # a dense 2048-block tile that overflows budget 16
    rs = np.random.RandomState(3)
    dense = np.zeros((32, 64, 64), np.int16)
    dense[..., 0] = rs.randint(-300, 300, (32, 64))
    dense[..., 1:] = np.where(rs.rand(32, 64, 63) < 0.5, -1, 1) \
        * rs.randint(512, 1024, (32, 64, 63))
    layout = device_entropy.scan_layout(((1, 1),), 64, 32)
    pays, lens = pk.slots_for_kernel([torch.from_numpy(dense).to(dev)],
                                     layout)
    yield ("pack_tiles", "an overflowing tile",
           lambda: pk.pack_tiles(pays, lens, 16),
           lambda: pk.pack_tiles_plain(pays, lens, 16), tiles_equal)
    tile = pk._TILE
    for what, n, dense in (
            ("a single block", 1, ()), ("less than a sub-tile", 100, ()),
            ("no multiple of a sub-tile", tile + 5 * 128 + 57, ()),
            ("4 tiles, the last ragged", 3 * tile + 333, ()),
            ("3 tiles, the middle one overflowing", 3 * tile,
             ((tile + 640, 2 * tile),))):
        pays, lens = (t.to(dev) for t in testing.synthetic_slots(
            n, seed=n, dense=dense))
        yield ("pack_blocks", what,
               lambda p=pays, n=lens: pk.pack_blocks(p, n),
               lambda p=pays, n=lens: pk.pack_blocks_plain(p, n), eq)
        yield ("pack_tiles", what,
               lambda p=pays, n=lens: pk.pack_tiles(p, n, 16),
               lambda p=pays, n=lens: pk.pack_tiles_plain(p, n, 16),
               tiles_equal)


def _apply_cases(dev, big: bool):
    import torch
    from .. import testing
    from ..ops import apply_kernel as ak
    from ..types import ColorGamut as CG, ColorTransfer as CT
    rs = np.random.RandomState(7)
    ah, aw = (2160, 3840) if big else (97, 203)
    sdr = torch.from_numpy(rs.rand(3, ah, aw).astype(np.float32) - np.array(
        [0.0, 0.5, 0.5], np.float32)[:, None, None]).to(dev)
    gain3 = torch.from_numpy(rs.randint(0, 256, (3, ah, aw)).astype(
        np.float32) / 255.0).to(dev)
    grid = itertools.product((CT.HLG, CT.PQ, CT.LINEAR), (False, True),
                             (1, 3), (1.0, 1.571))
    if big:
        grid = itertools.product((CT.HLG, CT.LINEAR), (False,), (1, 3),
                                 (1.0,))
    for out_ct, use_base_cg, chans, gamma in grid:
        rows = np.array([[gamma] * 3, [1.0, 1.0, 1.0],
                         [1000.0 / 203.0, 4.0, 4.9], [1e-7] * 3, [1e-7] * 3],
                        np.float32)
        kw = dict(out_ct=out_ct, sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100,
                  use_base_cg=use_base_cg)
        g = gain3[:chans].contiguous()
        yield ("apply_gainmap_linear" if out_ct == CT.LINEAR
               else "apply_gainmap",
               f"{out_ct.name} base_cg {use_base_cg} {chans}-channel gamma "
               f"{gamma} {aw}x{ah}",
               lambda g=g, rows=rows, kw=kw: ak.apply_gainmap(
                   sdr, g, rows, 0.31, **kw),
               lambda g=g, rows=rows, kw=kw: ak.apply_gainmap_plain(
                   sdr, g, rows, 0.31, **kw), tensors_equal)
    if big:
        return
    for (eh, ew), out_ct, chans, gamma in itertools.product(
            ((48, 64), (37, 53)), (CT.HLG, CT.PQ, CT.LINEAR), (1, 3),
            (1.0, 1.571)):
        sdr_e, gain_e, rows_e = testing.apply_edge_inputs(eh, ew, chans,
                                                          gamma)
        sdr_e, gain_e = (torch.from_numpy(a).to(dev) for a in (sdr_e, gain_e))
        kw = dict(out_ct=out_ct, sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100,
                  use_base_cg=gamma != 1.0)
        yield ("apply_gainmap_linear" if out_ct == CT.LINEAR
               else "apply_gainmap",
               f"{out_ct.name} {chans}-channel gamma {gamma} edge inputs "
               f"{ew}x{eh}",
               lambda s=sdr_e, g=gain_e, r=rows_e, kw=kw: ak.apply_gainmap(
                   s, g, r, 0.8, **kw),
               lambda s=sdr_e, g=gain_e, r=rows_e, kw=kw:
               ak.apply_gainmap_plain(s, g, r, 0.8, **kw), tensors_equal)


def _scan_cases(dev, big: bool):
    import torch
    from .. import fused
    from ..jpeg import dct
    from ..jpeg.tables import (STD_CHROMA_QUANT, STD_LUMA_QUANT,
                               scaled_quant_table)
    rs = np.random.RandomState(3)
    nh, nw = (2160, 3840) if big else (736, 1032)
    noise = torch.from_numpy(rs.randint(0, 256, (3, nh, nw)).astype(
        np.uint8)).to(dev)

    def scan(kind, w_, h_, quality, fill=None, view=None):
        tables = [scaled_quant_table(t, quality) for t in (
            STD_LUMA_QUANT, STD_CHROMA_QUANT, STD_CHROMA_QUANT)]
        sub = {"420": [(h_, w_)] + [(-(-h_ // 2), -(-w_ // 2))] * 2,
               "444": [(h_, w_)] * 3, "rgb": [(h_, w_)] * 3,
               "400": [(h_, w_)]}[kind]
        planes = []
        for i, (ph, pw) in enumerate(sub):
            if fill is not None:
                planes.append(torch.full((ph, pw), fill, dtype=torch.uint8,
                                         device=dev))
            elif view == "columns":
                planes.append(noise[i, :ph, 8:8 + pw])
            else:
                planes.append(noise[i, 8:8 + ph, :pw] if view == "rows"
                              else noise[i, :ph, :pw])
        sampling = {"420": fused._SAMPLING_420,
                    "400": fused._SAMPLING_400}.get(kind,
                                                    fused._SAMPLING_444)
        return fused._scan(planes, sampling, tables[:len(planes)],
                           rgb=kind == "rgb")

    if big:     # the default 4K request's two scans, in one launch
        pair = [scan("420", 3840, 2160, 95), scan("rgb", 3840, 2160, 95)]
        yield ("forward_dct", "4K 4:2:0 base and RGB map, one launch",
               lambda: dct.scan_inputs(pair),
               lambda: dct.scan_inputs_plain(pair), tensors_equal)
        return
    edge = []
    for kind in ("420", "444", "rgb", "400"):
        step = 16 if kind == "420" else 8
        for what, w_, h_, quality, fill, view in (
                ("one MCU", step, step, 95, None, None),
                ("31 MCUs", 31 * step, step, 95, None, None),
                ("32 MCUs", 32 * step, 2 * step, 95, None, None),
                ("24x16 MCUs", 24 * step, 16 * step, 95, None, None),
                ("37x21 MCUs, 2 short", 37 * step - 2, 21 * step - 2, 90,
                 None, None),
                ("61x45 MCUs, 3 short", 61 * step - 3, 45 * step - 3, 60,
                 None, None),
                ("all 0", 3 * step, 2 * step, 100, 0, None),
                ("all 255", 3 * step, 2 * step, 1, 255, None),
                ("column slice", 5 * step - 1, 3 * step, 100, None,
                 "columns"),
                ("row slice", 9 * step, 4 * step + 3, 50, None, "rows")):
            edge.append((f"{kind} {what}", scan(kind, w_, h_, quality, fill,
                                                view)))
    for what, s in edge:
        yield ("forward_dct", what, lambda s=s: dct.scan_inputs([s]),
               lambda s=s: dct.scan_inputs_plain([s]), tensors_equal)
    pair = [edge[3][1], edge[23][1]]
    yield ("forward_dct", "two scans back to back",
           lambda: dct.scan_inputs(pair), lambda: dct.scan_inputs_plain(pair),
           tensors_equal)
    for what, plane, quality in (
            ("one block", noise[0, :8, :8], 95),
            ("129 x 92 blocks", noise[0, :, :1032], 95),
            ("a column slice", noise[1, :64, 8:112], 80)):
        for table in (STD_LUMA_QUANT, STD_CHROMA_QUANT):
            q = scaled_quant_table(table, quality)
            yield ("forward_dct", f"forward_plane on {what}",
                   lambda p=plane, q=q: dct.forward_plane(p, q),
                   lambda p=plane, q=q: dct.forward_plane_plain(p, q),
                   tensors_equal)


def _wire_cases(dev, big: bool):
    import torch
    from ..ops import wire_kernel as wk
    rs = np.random.RandomState(18)

    def rand_words(n):
        return torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, n,
                                           dtype=np.int64)
                                .astype(np.int32)).to(dev)

    sizes = (3840 * 2160,) if big else (1, 31, 32, 32 * 1000 + 7)
    for bits in ((4, 8) if big else range(2, 9)):
        for n in sizes:
            pay = rand_words(-(-n // 32) * bits)
            yield ("wire_unslice", f"fixed {bits} bits, {n} samples",
                   lambda p=pay, n=n, b=bits: wk.unslice(p, n, bits=b),
                   lambda p=pay, n=n, b=bits: wk.unslice_plain(p, n, bits=b),
                   tensors_equal)
    vw_cases = [rs.randint(0, 13, 3840 * 2160 // 32)] if big else [
        rs.randint(0, 16, 37), rs.randint(0, 16, 4099),
        np.zeros(64, np.int64), np.full(64, 12), np.full(9, 15)]
    if not big:
        vw_cases[0][:3] = (0, 12, 0)
    for k, wid in enumerate(vw_cases):
        wid_t = torch.from_numpy(wid.astype(np.int32)).to(dev)
        offs = torch.cumsum(wid_t, 0, dtype=torch.int32) - wid_t
        # the second small case's payload ends mid-group: indices clamp
        live = int(np.minimum(wid, 12).sum())
        pay = rand_words(max(1, live // 2 if k == 1 and not big else live))
        for n in (32 * wid.size, 32 * wid.size - 5):
            yield ("wire_unslice", f"vw case {k}, {n} samples",
                   lambda p=pay, n=n, w=wid_t, o=offs: wk.unslice(
                       p, n, widths=w, offsets=o),
                   lambda p=pay, n=n, w=wid_t, o=offs: wk.unslice_plain(
                       p, n, widths=w, offsets=o),
                   tensors_equal)

    def packed_output(fmt, h_, w_, noisy):
        yy, xx = np.mgrid[0:h_, 0:w_]
        chans = [(300 + 2 * xx + yy + c * 50
                  + (rs.randint(0, 400, (h_, w_)) if noisy else 0)) % 1024
                 for c in range(3)]
        for ch in chans:
            ch[0, 0], ch[-1, -1] = 1023, 0
        if fmt == "1010102":
            p = (chans[0] | chans[1] << 10 | chans[2] << 20
                 | 3 << 30).astype(np.uint32)
            return torch.from_numpy(p.view(np.int32)).to(dev)
        comp = np.stack([0x3000 + 16 * c for c in chans]
                        + [np.full((h_, w_), 0x3C00)], -1).astype(np.uint16)
        return torch.from_numpy(comp.view(np.int16)).to(dev)

    if not big:
        from .. import testing
        for name, pay, n, bits, wid, offs, align in \
                testing.unslice_edge_cases():
            p = testing.aligned_tensor(pay, align, dev)
            w_ = o_ = None
            if wid is not None:
                w_ = torch.from_numpy(wid).to(dev)
                o_ = (torch.cumsum(w_, 0, dtype=torch.int32) - w_
                      if offs is None else torch.from_numpy(offs).to(dev))
            yield ("wire_unslice", name,
                   lambda p=p, n=n, b=bits, w=w_, o=o_: wk.unslice(
                       p, n, bits=b, widths=w, offsets=o),
                   lambda p=p, n=n, b=bits, w=w_, o=o_: wk.unslice_plain(
                       p, n, bits=b, widths=w, offsets=o),
                   tensors_equal)
        for name, packed, bits, cap, align in testing.down_pack_edge_cases():
            pt = testing.aligned_tensor(packed, align, dev)
            yield ("down_pack", name,
                   lambda p=pt, b=bits, c=cap: wk.down_pack(p, bits=b, cap=c),
                   lambda p=pt, b=bits, c=cap: wk.down_pack_plain(
                       p, bits=b, cap=c),
                   tensors_equal)
    shapes = (((2160, 3840), False, wk.DOWN_ESC),
              ((2160, 3840), True, wk.DOWN_ESC)) if big else (
        ((37, 53), False, wk.DOWN_ESC), ((64, 32), False, wk.DOWN_ESC),
        ((37, 53), True, 16))
    for fmt in ("1010102", "f16"):
        for bits in ((4,) if big else (3, 4, 6, 8)):
            for (h_, w_), noisy, cap in shapes:
                packed = packed_output(fmt, h_, w_, noisy)
                kind = "noisy" if noisy else "smooth"
                yield ("down_pack", f"{fmt} {bits} bits {w_}x{h_} {kind} "
                       f"cap {cap}",
                       lambda p=packed, b=bits, c=cap: wk.down_pack(
                           p, bits=b, cap=c),
                       lambda p=packed, b=bits, c=cap: wk.down_pack_plain(
                           p, bits=b, cap=c),
                       tensors_equal)


def _stitch_cases(dev, big: bool):
    import torch
    from .. import testing
    from ..jpeg import pack_kernel as pk
    from ..ops import stitch_kernel as sk
    if big:
        # 8 default 4K images' rooms (583,200 blocks, CAP_WORDS words
        # each), their live counts about a photo's
        pitch = -(-583200 * pk.CAP_WORDS // 4) * 4
        gen = torch.Generator(device=dev).manual_seed(22)
        room = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, pitch),
                             dtype=torch.int32, device=dev, generator=gen)
        counts = np.array([2_500_000 + 40_001 * i for i in range(8)])
        todo = [("k = 8 at 4K, rooms of 583200 blocks", room, counts)]
    else:
        todo = [(name, torch.from_numpy(r).to(dev), c)
                for name, r, c in testing.stitch_edge_cases()]
    for name, room, counts in todo:
        total = int(np.clip(counts, 0, room.shape[1]).sum())
        # the counts as the route passes them: column 1 of scratch rows
        scratch = torch.zeros((len(counts), 3), dtype=torch.int64,
                              device=dev)
        scratch[:, 1] = torch.from_numpy(counts.astype(np.int64)).to(dev)
        yield ("stitch", name,
               lambda r=room, c=scratch[:, 1], t=total: sk.stitch(r, c)[:t],
               lambda r=room, c=scratch[:, 1], t=total: sk.stitch_plain(
                   r, c)[:t],
               tensors_equal)


def cases(dev, shapes: str = "small"):
    """Every case at `shapes` ("small", "4k" or "all")."""
    for big in {"small": (False,), "4k": (True,),
                "all": (False, True)}[shapes]:
        for gen in (_pack_cases, _apply_cases, _scan_cases, _wire_cases,
                    _stitch_cases):
            yield from gen(dev, big)


def launch_counts() -> dict:
    """Each kernel's launch count so far (the apply's LINEAR branch
    apart from its HLG/PQ one)."""
    from ..jpeg import dct, pack_kernel as pk
    from ..ops import apply_kernel as ak, stitch_kernel as sk
    from ..ops import wire_kernel as wk
    linear = ak.APPLY_KERNEL.linear_launches
    return {"pack_scan": pk.PACK_KERNEL.launches,
            "pack_blocks": pk.PACK_BLOCKS_KERNEL.launches,
            "pack_tiles": pk.PACK_TILES_KERNEL.launches,
            "apply_gainmap": ak.APPLY_KERNEL.launches - linear,
            "apply_gainmap_linear": linear,
            "forward_dct": dct.FORWARD_DCT_KERNEL.launches,
            "wire_unslice": wk.UNSLICE_KERNEL.launches,
            "down_pack": wk.DOWN_PACK_KERNEL.launches,
            "stitch": sk.STITCH_KERNEL.launches}


def run(dev, shapes: str = "small", repeat: int = 1, log=print) -> dict:
    """Every case at `shapes`: the wrapper's outputs against the plain
    version's (`repeat` > 1: the wrapper run that many times, each equal to
    the first, while a side stream keeps the card busy).  Returns per
    kernel {cases, launches, seconds}; raises AssertionError on the first
    difference."""
    import torch
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stats = {k: {"cases": 0, "launches": 0, "seconds": 0.0} for k in KERNELS}
    noise = torch.cuda.Stream(dev) if cuda and repeat > 1 else None
    for kernel, what, fn, plain, compare in cases(dev, shapes):
        log(f"case {kernel}: {what}")
        before = launch_counts()
        t0 = time.perf_counter()
        got = fn()
        sync()
        compare(as_tuple(got), as_tuple(plain()), f"{kernel} on {what}")
        for _ in range(repeat - 1):
            if noise is not None:
                with torch.cuda.stream(noise):
                    torch.cuda._sleep(200_000)
            compare(as_tuple(fn()), as_tuple(got),
                    f"{kernel} on {what}, run again")
        sync()
        after = launch_counts()
        st = stats[kernel]
        st["cases"] += 1
        st["seconds"] += time.perf_counter() - t0
        for k in KERNELS:
            stats[k]["launches"] += after[k] - before[k]
    if noise is not None:
        torch.cuda.synchronize()
    return stats


def install_guard(side: str, fill: int):
    """Build tools/guard_alloc.cpp (the host compiler, the CUDA headers of
    the toolkit nvcc belongs to) and make it PyTorch's CUDA allocator; must
    come before the process's first CUDA allocation."""
    import pathlib
    import torch
    from .. import _buildlib
    cuda_home = pathlib.Path(_buildlib.nvcc()).resolve().parent.parent
    src = pathlib.Path(__file__).resolve().parent / "guard_alloc.cpp"
    so, _ = _buildlib.build_shared(
        "guard_alloc", [src],
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror",
         f"-I{cuda_home / 'include'}"], libs=["-ldl"])
    os.environ["UHDR_GUARD_SIDE"] = side
    os.environ["UHDR_GUARD_FILL"] = str(fill)
    alloc = torch.cuda.memory.CUDAPluggableAllocator(
        str(so), "uhdr_guard_alloc", "uhdr_guard_free")
    torch.cuda.memory.change_current_allocator(alloc)
    import ctypes
    lib = ctypes.CDLL(str(so))
    lib.uhdr_guard_stat.restype = ctypes.c_longlong
    lib.uhdr_guard_stat.argtypes = [ctypes.c_int]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libultrahdr_tpu_torch.tools.sanitize_kernels",
        description="every CUDA kernel of the port against its plain "
                    "version, for compute-sanitizer or under guard pages")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--tool", choices=TOOLS,
                      help="the compute-sanitizer tool this process runs "
                           "under (memcheck also runs the 4K shapes)")
    mode.add_argument("--guard", choices=("right", "left"),
                      help="guard pages after (right) or before (left) "
                           "every tensor; small and 4K shapes")
    mode.add_argument("--repeat", type=int,
                      help="every small case this many times beside a busy "
                           "stream")
    ap.add_argument("--fill", type=lambda s: int(s, 0), default=0xA5,
                    help="the byte new guard mappings are filled with")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sanitize_kernels: CUDA is not available; this "
                         "program runs only on a GPU")
    guard = install_guard(args.guard, args.fill) if args.guard else None
    dev = torch.device("cuda", 0)
    shapes = "all" if args.guard or args.tool == "memcheck" else "small"
    t0 = time.perf_counter()
    stats = run(dev, shapes, repeat=args.repeat or 1,
                log=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    mode = f"tool {args.tool}" if args.tool else \
        f"guard {args.guard} fill {args.fill:#04x}" if args.guard else \
        f"repeat {args.repeat}"
    result = {"mode": mode, "shapes": shapes,
              "seconds": time.perf_counter() - t0, "kernels": stats,
              "device": torch.cuda.get_device_name(0)}
    if guard is not None:
        result["guard"] = {"allocations": guard.uhdr_guard_stat(0),
                           "frees": guard.uhdr_guard_stat(1),
                           "cuda_failures": guard.uhdr_guard_stat(2)}
        if result["guard"]["cuda_failures"]:
            raise SystemExit(f"guard allocator: CUDA calls failed: "
                             f"{result['guard']}")
    for k, st in stats.items():
        print(f"kernel {k}: {st['cases']} cases, {st['launches']} launches, "
              f"{st['seconds']:.2f} s, every output == plain", flush=True)
    if any(st["launches"] == 0 for st in stats.values()):
        raise SystemExit(f"a kernel was never launched: {stats}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
