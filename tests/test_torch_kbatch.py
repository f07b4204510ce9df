"""PyTorch port: the K-batch route of the pipelined encode and its stitch,
on the CPU.

With ``UHDR_TPU_WIRE`` set, ``fused.encode_api0_p010_pipelined`` chunks
uniform images into K-batches as the JAX package does
(``UHDR_TPU_BATCH_K``, ``UHDR_TPU_CHUNK_BYTES``): one stacked upload of
their wires, each image's stages and pack, one stitch of their words
(``ops/stitch_kernel``), one download.

- The units ``fused._batches`` forms follow the JAX package's rules: K from
  both knobs, a break at a non-uniform image or another wire mode, an image
  whose wire falls back alone, no wire packed twice.
- At 128x96 and 256x128, over the vw wire and the fixed 2D 5-bit rung, with
  K 2 and 3 (each size, wire and K twice) and a non-uniform image breaking a
  batch, every file equals ``JpegR.encode_api0`` of its image byte for byte.
- Against the JAX package's pipelined encode under the same knobs (128x96
  over vw with the non-uniform image, 256x128 over 2d5; batches of 3 and 2
  in each): with the JAX files' quantised coefficients fed in place of the
  port's float stages, the route gives the JAX files byte for byte, and
  each image's wire decodes to its raw planes on the way.  (The float stages themselves
  are held to the JAX package in tests/test_torch_ops.py and
  tests/test_torch_pipeline.py.)
- The stitch's plain version against a numpy model of the kernel
  (``csrc/stitch_kernel.cu``: 16-byte groups, the image of a group's first
  word by binary search, images of 0 live words stepped over, the short
  last group word by word) and against plain concatenation, on
  ``testing.stitch_edge_cases``.
- The claim that the port's pack cannot overflow a K-batch's rows: the
  worst-case blocks fit CAP_WORDS words.
"""

import functools

import numpy as np
import pytest
import torch

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing, wire
from libultrahdr_tpu_torch.jpeg import pack_kernel
from libultrahdr_tpu_torch.ops import stitch_kernel

from test_torch_jax_native import guard_jax_native

guard_jax_native()

SIZES = ((128, 96), (256, 128))
WIRES = ("vw", "2d5")
KNOBS = ("UHDR_TPU_WIRE", "UHDR_TPU_BATCH_K", "UHDR_TPU_CHUNK_BYTES")


def _knobs(monkeypatch, **env):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def _odd_one(w, h):
    """Uniform with nothing else: the same size, another transfer."""
    img = testing.photo_p010(w, h, seed=9)
    img.ct = port.ColorTransfer.PQ
    return img


@functools.lru_cache(maxsize=None)
def _images(w, h, odd=True):
    """Six images, two uniform runs around a non-uniform one, or the five
    uniform ones."""
    imgs = [testing.photo_p010(w, h, seed=s) for s in range(5)]
    return tuple(imgs[:3] + [_odd_one(w, h)] * odd + imgs[3:])


@functools.lru_cache(maxsize=None)
def _singles(w, h):
    """``JpegR.encode_api0`` of each of `_images(w, h)`, no wire knob set
    (the knobs are read at the call)."""
    import os
    assert not any(k in os.environ for k in KNOBS)
    return tuple(port.JpegR(device="cpu").encode_api0(im, 95)
                 for im in _images(w, h))


def _units(imgs):
    """The units of `imgs` as lists of their indices."""
    where = {id(im): i for i, im in enumerate(imgs)}
    return [[where[id(im)] for im in unit]
            for unit, _ in port_fused._batches(list(imgs))]


def test_units_follow_the_jax_chunking(monkeypatch):
    imgs = _images(128, 96)
    _knobs(monkeypatch)
    assert _units(imgs) == [[i] for i in range(6)]
    _knobs(monkeypatch, UHDR_TPU_WIRE="vw")
    # the default K 8; chunk bytes 20e6 over 524,288-byte wires allow 38
    assert _units(imgs) == [[0, 1, 2], [3], [4, 5]]
    _knobs(monkeypatch, UHDR_TPU_WIRE="vw", UHDR_TPU_BATCH_K=2)
    assert _units(imgs) == [[0, 1], [2], [3], [4, 5]]
    _knobs(monkeypatch, UHDR_TPU_WIRE="vw", UHDR_TPU_BATCH_K=0)
    assert _units(imgs) == [[i] for i in range(6)]
    # round(1.3e6 / 524288) = round(2.48) = 2, round(1.4e6 / ...) = 3,
    # round(2e5 / ...) = 0, so 1
    for chunk, k in ((1.3e6, 2), (1.4e6, 3), (2e5, 1)):
        _knobs(monkeypatch, UHDR_TPU_WIRE="vw", UHDR_TPU_CHUNK_BYTES=chunk)
        assert max(len(u) for u in _units(imgs)) == k


def test_units_break_at_another_wire_mode(monkeypatch):
    """An image whose wire packs in another mode (here its vw buffer is
    longer) or falls back to the dense 10-bit pack ends the batch; each
    wire is packed once."""
    imgs = list(_images(128, 96)[:3])
    packed = []
    real = wire._pack_wire_auto

    def pack(y, uv):
        packed.append(1)
        buf, mode = real(y, uv)
        if len(packed) == 2:
            return None, None
        if len(packed) == 3:
            return np.concatenate([buf, buf]), ("vw", 2 * buf.size)
        return buf, mode

    _knobs(monkeypatch, UHDR_TPU_WIRE="vw")
    monkeypatch.setattr(wire, "_pack_wire_auto", pack)
    units = list(port_fused._batches(imgs))
    assert [len(u) for u, _ in units] == [1, 1, 1]
    assert units[1][1] == [(None, None)]
    assert len(packed) == 3


@pytest.mark.parametrize("size,mode,k", [
    (SIZES[0], "vw", 2), (SIZES[0], "2d5", 3), (SIZES[1], "vw", 3),
    (SIZES[1], "2d5", 2)])
def test_kbatch_files_equal_single_encodes(monkeypatch, size, mode, k):
    imgs = list(_images(*size))
    _knobs(monkeypatch)
    want = list(_singles(*size))
    _knobs(monkeypatch, UHDR_TPU_WIRE=mode, UHDR_TPU_BATCH_K=k)
    wire.RODE.clear()
    stitched = []
    real = port_fused.stitch_kernel.stitch
    monkeypatch.setattr(port_fused.stitch_kernel, "stitch",
                        lambda room, counts, out=None: stitched.append(
                            room.shape[0]) or real(room, counts))
    got = port_fused.encode_api0_p010_pipelined(port.JpegR(device="cpu"),
                                                imgs, 95)
    assert got == want
    assert stitched == ([2, 2] if k == 2 else [3, 2])
    name = "vw" if mode == "vw" else "2d5"
    assert wire.RODE == {f"p010:{name}": 6}


# (size, wire, with the non-uniform image) of the JAX comparisons: each
# size and each wire once (the JAX package compiles a program for each)
JAX_CASES = [(SIZES[0], "vw", True), (SIZES[1], "2d5", False)]


@functools.lru_cache(maxsize=None)
def _jax_files(size, mode, odd):
    """The JAX package's pipelined encode of `_images(*size, odd)` under
    UHDR_TPU_WIRE=mode, UHDR_TPU_BATCH_K=3: batches of 3 and 2 (around the
    non-uniform image)."""
    import os
    env = {"UHDR_TPU_WIRE": mode, "UHDR_TPU_BATCH_K": "3"}
    old = {k: os.environ.get(k) for k in KNOBS}
    os.environ.update(env)
    os.environ.pop("UHDR_TPU_CHUNK_BYTES", None)
    try:
        imgs = [jax_types.RawImage(
            jax_types.ImgFmt.P010, jax_types.ColorGamut(int(im.cg)),
            jax_types.ColorTransfer(int(im.ct)),
            jax_types.ColorRange(int(im.range)), im.w, im.h,
            [np.asarray(p) for p in im.planes[:2]])
            for im in _images(*size, odd)]
        return tuple(jax_fused.encode_api0_p010_pipelined(
            jax_jpegr.JpegR(), imgs, 95))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _layouts(w, h):
    return [port_fused._layout_for(h, w, port_fused._SAMPLING_420),
            port_fused._layout_for(h, w, port_fused._SAMPLING_444)]


@pytest.mark.parametrize("size,mode,odd", JAX_CASES)
def test_kbatch_on_jax_coefficients_gives_jax_files(monkeypatch, size, mode,
                                                    odd):
    """The route with the JAX files' quantised coefficients in place of the
    port's float stages gives the JAX pipelined files byte for byte: the
    batches, their packs, the stitch, the joins and the containers are the
    JAX package's; the planes each wire decodes to are the raw planes."""
    w, h = size
    jax_files = _jax_files(size, mode, odd)
    imgs = list(_images(*size, odd))
    coeffs = [[([torch.from_numpy(c) for c in testing.decode_scan_coeffs(
        testing.read_jpegr(data)[part], layout)], layout)
        for part, layout in enumerate(_layouts(w, h))] for data in jax_files]
    calls = iter(zip(imgs, coeffs))

    def block_buffers(y, uv, **kw):
        img, scans = next(calls)
        for got, plane in zip((y, uv), img.planes[:2]):
            assert torch.equal(got, torch.from_numpy(
                np.asarray(plane, np.uint16).view(np.int16)))
        return scans

    _knobs(monkeypatch, UHDR_TPU_WIRE=mode, UHDR_TPU_BATCH_K=3)
    monkeypatch.setattr(port_fused, "_api0_p010_block_buffers",
                        block_buffers)
    outs = port_fused.encode_api0_p010_pipelined(port.JpegR(device="cpu"),
                                                 imgs, 95)
    assert tuple(outs) == jax_files


# ---------------------------------------------------------------------------
# the stitch

def stitch_model(room: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """csrc/stitch_kernel.cu in numpy: the counts clamped and their
    exclusive prefix; each 16-byte group of the output from the image of its
    first word (binary search), stepping to the next image where a word
    crosses into it; the short last group word by word.  Words past the
    total stay as they were (here -1)."""
    k, pitch = room.shape
    prefix = np.zeros(k + 1, np.int64)
    prefix[1:] = np.cumsum(np.clip(counts, 0, pitch))
    total = int(prefix[k])
    out = np.full(k * pitch, -1, np.int32)
    for g in range((total + 3) // 4):
        d0 = 4 * g
        lo, hi = 0, k - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if prefix[mid] <= d0:
                lo = mid
            else:
                hi = mid - 1
        img = lo
        for d in range(d0, min(d0 + 4, total)):
            while d >= prefix[img + 1]:
                img += 1
            out[d] = room[img, d - prefix[img]]
    return out


@pytest.mark.parametrize("case", range(len(testing.stitch_edge_cases())))
def test_stitch_plain_against_model(case):
    name, room, counts = testing.stitch_edge_cases()[case]
    k, pitch = room.shape
    live = np.clip(counts, 0, pitch)
    total = int(live.sum())
    want = np.concatenate([room[i, :c] for i, c in enumerate(live)])
    model = stitch_model(room, counts)
    assert np.array_equal(model[:total], want), name
    assert (model[total:] == -1).all(), name
    got = stitch_kernel.stitch(torch.from_numpy(room),
                               torch.from_numpy(counts.astype(np.int64)))
    assert got.shape == (k * pitch,)
    assert torch.equal(got[:total], torch.from_numpy(want)), name
    assert not got[total:].any(), name


def test_stitch_reads_strided_counts():
    """The counts as the route passes them: column 1 of the k pack scratch
    rows."""
    _, room, counts = testing.stitch_edge_cases()[0]
    scratch = torch.zeros((room.shape[0], 5), dtype=torch.int64)
    scratch[:, 1] = torch.from_numpy(counts.astype(np.int64))
    a = stitch_kernel.stitch(torch.from_numpy(room), scratch[:, 1])
    b = stitch_kernel.stitch(torch.from_numpy(room),
                             torch.from_numpy(counts.astype(np.int64)))
    assert torch.equal(a, b)


def test_stitch_kernel_checks_its_inputs():
    room = torch.zeros((2, 8), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        stitch_kernel.STITCH_KERNEL(room, counts)
    with pytest.raises(port.UhdrError):
        stitch_kernel.stitch(room.to("meta"), counts.to("meta"))


def test_pack_cannot_overflow_a_batch_row():
    """Each image of a K-batch packs into a row of CAP_WORDS words a block:
    worst-case blocks (every coefficient at its longest code and 15 value
    bits) take at most that, so no image is cut short where the JAX
    package's per-image budget could overflow."""
    stream, dc_diff, is_luma = testing.pack_worst_case_stream()
    words, blen = pack_kernel.pack_scan(stream, dc_diff, is_luma)
    assert int(blen.max()) <= 32 * pack_kernel.CAP_WORDS
    assert words.numel() <= stream.shape[0] * pack_kernel.CAP_WORDS
