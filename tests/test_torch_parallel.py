"""PyTorch port: the batch and multi-device layer (``parallel``) on meshes
of CPU devices, against the JAX package on its 8-virtual-device CPU mesh
and against the port's own single-device routes, on the same seeded
inputs.

Contracts:

- one-pass encode, JPEG pack and apply: the port's sharded output equals
  its single-device output bit for bit (byte for byte for scans and
  files);
- two-pass encode: the sharded map within 1 of the single-device map and
  the bounds within 1e-6 relative (the box mean and the reductions may
  reassociate per shard shape, as in tests/test_parallel.py);
- port against JAX: u8 planes and maps within 1 on at most 1e-3 of the
  samples, bounds within 1e-6 relative (tests/test_torch_ops.py), the
  IDW bit for bit, scans byte for byte on the same coefficients,
  the apply within ``testing.check_decoded_close``.

The card runs the same steps over ``[cuda:0] * 4`` in ``chip_smoke.py``
(phase 17), with the pack and apply kernels in place of their plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import parallel as jax_parallel
from libultrahdr_tpu.ops import idw as jax_idw
from libultrahdr_tpu.parallel import batch as jax_batch
from libultrahdr_tpu.types import ColorTransfer

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused, parallel, testing
from libultrahdr_tpu_torch.jpeg import device_entropy, native, pack_kernel
from libultrahdr_tpu_torch.jpeg.tables import (AC_CHROMA, AC_LUMA, DC_CHROMA,
                                               DC_LUMA)
from libultrahdr_tpu_torch.ops import apply as apply_ops, idw
from libultrahdr_tpu_torch.parallel import batch

CPU = torch.device("cpu")
CG, CT = port.ColorGamut, port.ColorTransfer


def _mesh(n_data, n_spatial):
    return parallel.make_mesh(n_data, n_spatial, [CPU] * 8)


def _p010_batch(b, h, w, seed=0):
    rs = np.random.RandomState(seed)
    y = (rs.randint(0, 1024, (b, h, w)).astype(np.uint16) << 6)
    uv = (rs.randint(0, 1024, (b, h // 2, w)).astype(np.uint16) << 6)
    return y, uv


def _photo_p010_batch(b, h, w, seed=0):
    """b photo_p010 images, the content of the port-against-JAX
    comparisons."""
    imgs = [testing.photo_p010(w, h, seed=seed + i) for i in range(b)]
    return (np.stack([np.asarray(im.planes[0], np.uint16) for im in imgs]),
            np.stack([np.asarray(im.planes[1], np.uint16) for im in imgs]))


def _t(a):
    """A u16 host plane as the int16 CPU tensor the port reads."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_u8_close(a, b, share=1e-3):
    a, b = _np(a).astype(np.int32), _np(b).astype(np.int32)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max(initial=0) <= 1
    assert (diff > 0).mean() <= share


def _assert_map_close(got, jitted, unjitted):
    """A u8 gain map against the JAX package's jitted program: within 1,
    on no larger share of the samples than the JAX functions run without
    jit differ from the same program (or 1e-3).  XLA fuses and reorders
    the float ops, and on a flat map one ulp moves encode_gain's truncation
    for most samples (a 32x64 photo_p010 at seed 4: 71%)."""
    own = (_np(unjitted) != _np(jitted)).mean()
    _assert_u8_close(got, jitted, max(1e-3, own))


def _assert_bounds_close(a, b):
    """Two-pass log2 bounds of the two packages: a few float32 ulps of the
    log2 range (|bound| <= 16), log2 differing by an ulp between them."""
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_axes_and_row_shard_error():
    mesh = _mesh(4, 2)
    assert mesh.shape == dict(jax_parallel.make_mesh(4, 2).shape)
    assert mesh.axis_names == jax_parallel.make_mesh(4, 2).axis_names
    assert [[d.type for d in row] for row in mesh.devices] == [["cpu"] * 2] * 4
    for args in ((40, 8, 8), (64, 3, 8), (48, 4, 8)):
        with pytest.raises(ValueError) as want:
            jax_batch._check_row_shard(*args)
        with pytest.raises(ValueError) as got:
            batch._check_row_shard(*args)
        assert str(got.value) == str(want.value)
    y, uv = _p010_batch(1, 40, 128)          # 40 / 8 = 5 rows: odd, not /4
    with pytest.raises(ValueError):
        parallel.sharded_encode_step(_mesh(1, 8), scale=4)(y, uv)
    with pytest.raises(ValueError):
        parallel.make_mesh(3, 3, [CPU] * 8)


def test_make_mesh_needs_a_gpu_by_default(monkeypatch):
    """With no device list the mesh is every CUDA device: with no GPU it
    raises instead of running elsewhere; a repeated device is a mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port.UhdrError) as e:
        parallel.make_mesh()
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
    y, uv = _p010_batch(1, 16, 16)
    with pytest.raises(port.UhdrError):
        parallel.encode_core_p010(y[0], uv[0])
    assert parallel.make_mesh(devices=[CPU] * 4).shape == {"data": 4,
                                                           "spatial": 1}


# ---------------------------------------------------------------------------
# the single-device steps


def _unjitted(y, uv, two_pass, **kw):
    """The JAX package's pixel step of one image without jit."""
    kw = dict(dict(cg=CG.BT2100, ct=CT.HLG, rng=port.ColorRange.FULL,
                   gamma=1.0), **kw)
    with jax.disable_jit():
        if two_pass:
            return jax_batch._encode_pixels_p010_twopass(y, uv, **kw)
        return jax_batch._encode_pixels_p010(jnp.asarray(y), jnp.asarray(uv),
                                             **kw)


def test_noise_pixels_equal_unjitted_jax():
    """On uniform noise the port's one-pass pixel step equals the JAX
    package's step function run without jit, bit for bit; its two-pass
    step too, but for the bounds (log2 differs by an ulp)."""
    y, uv = _p010_batch(1, 64, 128, seed=2)
    kw = dict(scale=2, multichannel=True)
    got = parallel.encode_core_p010(_t(y[0]), _t(uv[0]), **kw)
    for g, w in zip(got, _unjitted(y[0], uv[0], False, **kw)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = parallel.encode_core_p010_twopass(_t(y[0]), _t(uv[0]), **kw)
    want = _unjitted(y[0], uv[0], True, **kw)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[4:], want[4:]):
        _assert_bounds_close(g, w)


@pytest.mark.parametrize("two_pass", [False, True])
def test_single_image_cores_match_jax(two_pass):
    y, uv = _photo_p010_batch(1, 64, 128, seed=2)
    kw = dict(scale=4 if two_pass else 2, multichannel=True)
    core = parallel.encode_core_p010_twopass if two_pass \
        else parallel.encode_core_p010
    got = core(y[0], uv[0], device="cpu", **kw)
    want = (jax_parallel.encode_core_p010_twopass if two_pass
            else jax_parallel.encode_core_p010)(y[0], uv[0], **kw)
    assert len(got) == len(want)
    for g, w in zip(got[:3], want[:3]):
        _assert_u8_close(g, w)
    _assert_map_close(got[3], want[3], _unjitted(y[0], uv[0], two_pass,
                                                 **kw)[3])
    for g, w in zip(got[4:], want[4:]):
        _assert_bounds_close(g, w)


def test_encode_batch_matches_jax_and_cores():
    y, uv = _photo_p010_batch(3, 32, 64, seed=3)
    got = parallel.encode_batch_p010(y, uv, scale=2, device="cpu")
    want = jax_parallel.encode_batch_p010(y, uv, scale=2)
    for g, w in zip(got[:3], want[:3]):
        _assert_u8_close(g, w)
    for i in range(3):
        _assert_map_close(got[3][i], want[3][i], _unjitted(
            y[i], uv[i], False, scale=2, multichannel=False)[3])
        one = parallel.encode_core_p010(_t(y[i]), _t(uv[i]), scale=2)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize("k,n_shards,channels", [(2, 4, 3), (4, 2, 1),
                                                 (4, 4, 3)])
def test_idw_upsample_sharded(k, n_shards, channels):
    """Each shard with the next shard's first row as its halo: the JAX
    package's sharded IDW bit for bit, and stacked, the port's IDW of the
    whole map."""
    rs = np.random.RandomState(k + n_shards)
    mh, mw = 8 * n_shards, 24
    gm = rs.randint(0, 256, (channels, mh, mw)).astype(np.float32) / 255.0
    rows = mh // n_shards
    parts = []
    for s in range(n_shards):
        own = gm[:, s * rows:(s + 1) * rows]
        last = s == n_shards - 1
        halo = own[:, -1:] if last else gm[:, (s + 1) * rows:][:, :1]
        got = idw.idw_upsample_sharded(torch.from_numpy(own),
                                       torch.from_numpy(halo), last, k,
                                       rows * k, mw * k)
        want = jax_idw.idw_upsample_sharded(jnp.asarray(own),
                                            jnp.asarray(halo),
                                            jnp.asarray(last), k, rows * k,
                                            mw * k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        parts.append(got)
    whole = idw.idw_upsample(torch.from_numpy(gm), k, mh * k, mw * k)
    assert torch.equal(torch.cat(parts, 1), whole)


# ---------------------------------------------------------------------------
# the sharded encode


@pytest.mark.parametrize("two_pass", [False, True])
def test_sharded_encode_step(two_pass):
    """Mesh (4, 2), four images: against JAX's sharded step, and against
    the port's single-device step of each image."""
    b, h, w = 4, 64, 128
    y, uv = _photo_p010_batch(b, h, w)
    mesh = _mesh(4, 2)
    outs = parallel.sharded_encode_step(mesh, scale=4, multichannel=True,
                                        two_pass=two_pass)(y, uv)
    assert len(outs) == (6 if two_pass else 4)
    for out in outs:                       # every shard on its mesh device
        assert len(out.shards) == 4 and all(len(r) == 2 for r in out.shards)
    got = [o.gather() for o in outs]
    jstep = jax_parallel.sharded_encode_step(
        jax_parallel.make_mesh(4, 2), scale=4, multichannel=True,
        two_pass=two_pass)
    want = jax.block_until_ready(jstep(y, uv))
    for g, wnt in zip(got[:4], want[:4]):
        _assert_u8_close(g, wnt)
    for g, wnt in zip(got[4:], want[4:]):
        _assert_bounds_close(g, wnt)
    for i in range(b):
        if two_pass:
            ref = parallel.encode_core_p010_twopass(_t(y[i]), _t(uv[i]),
                                                    scale=4)
            for g, r in zip(got[:3], ref[:3]):
                assert torch.equal(g[i], r)
            assert (got[3][i].int() - ref[3].int()).abs().max() <= 1
            for g, r in zip(got[4:], ref[4:]):
                _assert_bounds_close(g[i], r)
        else:
            ref = parallel.encode_core_p010(_t(y[i]), _t(uv[i]), scale=4,
                                            multichannel=True)
            for g, r in zip(got, ref):
                assert torch.equal(g[i], r)
    if two_pass:                  # the reduced bounds: one on every shard
        for out in outs[4:]:
            for row in out.shards:
                assert all(torch.equal(t, row[0]) for t in row)


def _single_scans(y, uv, scale, multichannel):
    """The port's single-device base and gain-map scans of one image (the
    fused encode's block buffers, one pack, the join) and their layouts."""
    scans = fused._api0_p010_block_buffers(
        _t(y), _t(uv), cg=CG.BT2100, ct=CT.HLG, rng=port.ColorRange.FULL,
        scale=scale, multichannel=multichannel, gamma=1.0, quality=95,
        map_quality=95, use_base_cg=False)
    words, blen = fused._pack_scans(scans, pack_kernel.pack_scan)
    layouts = [lay for _, lay in scans]
    return fused._join_scans(words.numpy().view(np.uint32), blen.numpy(),
                             layouts), layouts


def _scan_coeffs(scan: bytes, layout):
    comps = [{"h": hs, "v": vs, "dc_tbl": int(i > 0), "ac_tbl": int(i > 0)}
             for i, (hs, vs) in enumerate(layout.sampling)]
    coeffs, _ = native.decode_scan(
        scan, comps, layout.mcus_w, layout.mcus_h,
        [DC_LUMA, DC_CHROMA, None, None], [AC_LUMA, AC_CHROMA, None, None],
        restart_interval=layout.mcus_w)
    return coeffs


def _assemble_from(coeffs, layout, n_sp: int) -> bytes:
    """A scan's coefficient planes cut into n_sp shards of MCU rows, each
    shard's blocks packed alone (the port's stream glue and pack) and
    joined by ``assemble_sharded_scan``."""
    rows = layout.mcus_h // n_sp
    lay = device_entropy.scan_layout(layout.sampling, layout.mcus_w, rows)
    words, blens = [], []
    for s in range(n_sp):
        part = [torch.from_numpy(c[s * rows * vs:(s + 1) * rows * vs])
                for c, (_, vs) in zip(coeffs, layout.sampling)]
        w, b = pack_kernel.pack_scan(*device_entropy.stream_inputs(part, lay))
        words.append(w)
        blens.append(b)
    cap = max(w.numel() for w in words)
    padded = torch.stack([torch.nn.functional.pad(w, (0, cap - w.numel()))
                          for w in words])
    return batch.assemble_sharded_scan(padded, torch.stack(blens),
                                       layout.bpr)


def _photo_batch(h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = 480 + 290 * np.sin(xx / 113.0) * np.cos(yy / 31.0) \
        + rs.rand(h, w) * 40
    y = (np.clip(lum, 0, 1023).astype(np.uint16) << 6)[None]
    uv = (rs.randint(350, 650, (1, h // 2, w)).astype(np.uint16) << 6)
    return y, uv


@pytest.mark.parametrize("h,w,scale", [(512, 1024, 4), (128, 8192, 1)])
def test_sharded_jpeg_scans(h, w, scale):
    """One image over a (1, 8) mesh: the assembled scans equal the port's
    single-device scans byte for byte (at scale 1 the gain map's too, and
    the container).  On the same coefficients the port's scans are the JAX
    package's sharded scans: the JAX scan's coefficients, packed shard by
    shard by the port and joined by ``assemble_sharded_scan``, give the JAX
    scan byte for byte (the two DCTs round a tie apart now and then, so
    the coefficients themselves may differ).  The JAX decoder reads the
    port's container."""
    y, uv = _photo_batch(h, w, seed=h)
    n_sp = 8
    bw, bb, gw, gb = [o.gather() for o in batch.sharded_encode_jpeg_step(
        _mesh(1, n_sp), scale=scale, multichannel=False)(y, uv)]
    (base_ref, gm_ref), (bl, gl) = _single_scans(y[0], uv[0], scale, False)
    base = batch.assemble_sharded_scan(bw[0], bb[0].reshape(n_sp, -1),
                                       bl.bpr)
    gm = batch.assemble_sharded_scan(gw[0], gb[0].reshape(n_sp, -1), gl.bpr)
    assert base == base_ref
    if scale == 1:
        assert gm == gm_ref

    jstep = jax_batch.sharded_encode_jpeg_step(
        jax_parallel.make_mesh(1, n_sp), scale=scale, multichannel=False)
    jbw, jbb, jgw, jgb = jax.block_until_ready(jstep(y, uv))
    jscans = [jax_batch.assemble_sharded_scan(
        np.asarray(ws[0]), np.asarray(ls[0]).reshape(n_sp, -1), lay.bpr)
        for ws, ls, lay in ((jbw, jbb, bl), (jgw, jgb, gl))]
    for ours, theirs, lay in ((base, jscans[0], bl), (gm, jscans[1], gl)):
        assert _assemble_from(_scan_coeffs(theirs, lay), lay, n_sp) == theirs
        assert _assemble_from(_scan_coeffs(ours, lay), lay, n_sp) == ours

    jr = port.JpegR(device="cpu", map_dimension_scale_factor=scale,
                    use_multi_channel_gainmap=False)
    md = fused._onepass_metadata(jr, CT.HLG, use_base_cg=False)
    args = (jr, w, h, 95, base, fused._SAMPLING_420, CG.DISPLAY_P3, scale,
            gm, md, None, CT.HLG, CG.BT2100)
    container = fused._assemble_container(*args)
    if scale == 1:
        single = fused._assemble_container(*args[:4], base_ref,
                                           *args[5:8], gm_ref, *args[9:])
        assert container == single
    assert jax_jpegr.is_uhdr_image(container)
    out = jax_jpegr.JpegR().decode(container, output_ct=ColorTransfer.HLG)[0]
    assert (out.w, out.h) == (w, h)


def test_assemble_rejects_short_words():
    y, uv = _p010_batch(1, 32, 64, seed=5)
    bw, bb, _, _ = [o.gather() for o in batch.sharded_encode_jpeg_step(
        _mesh(1, 2), scale=2)(y, uv)]
    words = bw[0].reshape(2, -1)
    bpr = fused._layout_for(16, 64, fused._SAMPLING_420).bpr
    with pytest.raises(device_entropy.PackOverflowError):
        batch.assemble_sharded_scan(words[:, :4], bb[0].reshape(2, -1), bpr)


# ---------------------------------------------------------------------------
# the sharded apply


def _apply_inputs(scale_k, channels, seed):
    b, h, w = 2, 64, 128
    rs = np.random.RandomState(seed)
    sdr = rs.rand(b, 3, h, w).astype(np.float32)
    sdr[:, 1:] -= 0.5
    gain = rs.randint(0, 256, (b, channels, h // scale_k, w // scale_k)) \
        .astype(np.float32) / 255.0
    meta = {"gamma": np.full(3, 1.3, np.float32),
            "min_content_boost": np.ones(3, np.float32),
            "max_content_boost": np.full(3, 4.0, np.float32),
            "offset_sdr": np.full(3, 1e-7, np.float32),
            "offset_hdr": np.full(3, 1e-7, np.float32)}
    return sdr, gain, meta


@pytest.mark.parametrize("scale_k,channels", [(1, 3), (2, 3), (4, 1),
                                              (4, 3)])
def test_sharded_apply_step(scale_k, channels):
    """Mesh (2, 4): bit for bit the port's single-device apply, within
    check_decoded_close of the JAX package's sharded apply."""
    sdr, gain, meta = _apply_inputs(scale_k, channels, 3)
    for out_ct in (ColorTransfer.HLG, ColorTransfer.LINEAR):
        got = parallel.sharded_apply_step(_mesh(2, 4), scale_k=scale_k,
                                          out_ct=CT(out_ct))(sdr, gain, meta)
        got = got.gather()
        want = np.asarray(jax.block_until_ready(
            jax_parallel.sharded_apply_step(
                jax_parallel.make_mesh(2, 4), scale_k=scale_k,
                out_ct=out_ct)(sdr, gain, meta)))
        for i in range(sdr.shape[0]):
            single = apply_ops.apply_gainmap_core(
                torch.from_numpy(sdr[i]), torch.from_numpy(gain[i]), meta,
                scale_k=scale_k, weight=np.float32(1.0), out_ct=CT(out_ct),
                sdr_cg=CG.DISPLAY_P3, hdr_cg=CG.BT2100, use_base_cg=True)
            assert torch.equal(got[i], single)
            testing.check_decoded_close(got[i], want[i], CT(out_ct),
                                        f"scale {scale_k} {out_ct.name}")


def test_steps_take_tensors_and_gather_where_the_shards_are():
    """Tensor inputs give what host arrays give (the apply's SDR and map,
    the encode's int16 planes), and ``Sharded.gather`` joins the shards on
    the first shard's device unless told otherwise."""
    sdr, gain, meta = _apply_inputs(2, 3, 5)
    step = parallel.sharded_apply_step(_mesh(2, 2), scale_k=2)
    want = step(sdr, gain, meta)
    got = step(torch.from_numpy(sdr), torch.from_numpy(gain), meta)
    assert got.gather().device == CPU
    assert torch.equal(got.gather(), want.gather(CPU))
    y, uv = _photo_p010_batch(2, 32, 64)
    enc = parallel.sharded_encode_step(_mesh(2, 2), two_pass=False)
    for g, w in zip(enc(_t(y), _t(uv)), enc(y, uv)):
        assert torch.equal(g.gather(), w.gather())
