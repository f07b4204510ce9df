"""The forward DCT's kernel contract on one plane, on the CPU.

``csrc/dct_kernel.cu`` runs only on the card (``chip_smoke.py`` holds it
against ``forward_plane_plain`` there, bit for bit); a plane is a
one-component scan of it.  Here: the arithmetic the kernel is written to,
every product and sum of the two passes rounded on its own in index order,
then a correctly rounded division and the round half to even of
(q + 1.5 x 2^23), modelled in numpy float32, equals the plain version bit
for bit; the coefficients of a row shard equal the whole plane's; the
parameters the wrapper hands the kernel; and the dispatcher's routes.
``tests/test_torch_scan_kernel.py`` models the whole kernel.
"""

import numpy as np
import pytest
import torch

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch.jpeg import dct
from libultrahdr_tpu_torch.jpeg.tables import (INV_ZIGZAG, STD_CHROMA_QUANT,
                                               STD_LUMA_QUANT,
                                               scaled_quant_table)


def _plane(h, w, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (h, w)).astype(np.uint8)


def _kernel_model(plane, q):
    """The kernel's sequence of float32 operations, a block per row of the
    (n, 8, 8) arrays: t[u][c] = ((D[u][0] x[0][c] + D[u][1] x[1][c]) + ...),
    y[u][v] = ((t[u][0] D[v][0] + t[u][1] D[v][1]) + ...), rint(y / Q) at
    its zigzag position, the rounding as the kernel's (q + 1.5 x 2^23)."""
    h, w = plane.shape
    x = plane.astype(np.float32) - np.float32(128)
    x = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
        -1, 8, 8)
    d = dct.dct_matrix()
    t = np.empty_like(x)
    for u in range(8):
        acc = d[u, 0] * x[:, 0, :]
        for k in range(1, 8):
            acc = acc + d[u, k] * x[:, k, :]
        t[:, u, :] = acc
    y = np.empty_like(x)
    for v in range(8):
        acc = t[:, :, 0] * d[v, 0]
        for k in range(1, 8):
            acc = acc + t[:, :, k] * d[v, k]
        y[:, :, v] = acc
    quotient = y / np.asarray(q, np.float32).reshape(8, 8)
    quant = ((quotient + np.float32(12582912.0)).view(np.int32)
             - np.int32(0x4B400000)).astype(np.int16).reshape(-1, 64)
    out = np.empty_like(quant)
    out[:, INV_ZIGZAG] = quant
    return out.reshape(h // 8, w // 8, 64)


@pytest.mark.parametrize("h,w,seed", [(8, 8, 0), (24, 40, 1), (64, 136, 2)])
@pytest.mark.parametrize("quality,chroma", [(95, False), (60, True),
                                            (100, False)])
def test_kernel_arithmetic_equals_plain(h, w, seed, quality, chroma):
    plane = _plane(h, w, seed + quality)
    q = scaled_quant_table(STD_CHROMA_QUANT if chroma else STD_LUMA_QUANT,
                           quality)
    got = dct.forward_plane_plain(torch.from_numpy(plane), q).numpy()
    np.testing.assert_array_equal(got, _kernel_model(plane, q))


@pytest.mark.parametrize("parts", [2, 3])
def test_row_shards_equal_the_whole_plane(parts):
    plane = torch.from_numpy(_plane(48, 64, parts))
    q = scaled_quant_table(STD_LUMA_QUANT, 95)
    whole = dct.forward_plane(plane, q)
    split = torch.cat([dct.forward_plane(p, q)
                       for p in plane.split(48 // parts)])
    assert torch.equal(whole, split)


def test_kernel_params():
    """The launch-independent ScanParams: D, each component's table in
    natural order, each natural index's zigzag position, and per MCU block
    its component and the block whose DC precedes it (4:2:0: Y blocks 0-3,
    the first after the left MCU's last, then Cb, Cr after the left
    MCU's)."""
    q = np.stack([np.asarray(scaled_quant_table(t, 90), np.float32)
                  for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT,
                            STD_CHROMA_QUANT)])
    p = dct._ScanParams.from_buffer_copy(dct._scan_params(
        ((2, 2), (1, 1), (1, 1)), 5, 3, q.tobytes()))
    np.testing.assert_array_equal(np.ctypeslib.as_array(p.d),
                                  dct.dct_matrix().ravel())
    np.testing.assert_array_equal(np.ctypeslib.as_array(p.q), q)
    np.testing.assert_array_equal(np.ctypeslib.as_array(p.pos), INV_ZIGZAG)
    assert (p.n_comp, p.mcus_w, p.mcus_h, p.bpm, p.bpr) == (3, 5, 3, 6, 30)
    assert list(p.comp_of)[:6] == [0, 0, 0, 0, 1, 2]
    assert list(p.prev_of)[:6] == [3, 0, 1, 2, 4, 5]
    assert list(p.first_of)[:6] == [1, 0, 0, 0, 1, 1]


def test_forward_dct_dispatch_never_falls_back():
    """A CPU tensor takes the plain version; the kernel wrapper refuses a
    CPU tensor and counts nothing; another device raises."""
    plane = torch.from_numpy(_plane(16, 16, 3))
    q = scaled_quant_table(STD_LUMA_QUANT, 95)
    assert torch.equal(dct.forward_plane(plane, q),
                       dct.forward_plane_plain(plane, q))
    before = dct.FORWARD_DCT_KERNEL.launches
    with pytest.raises(ValueError):
        dct.FORWARD_DCT_KERNEL(plane, q)
    assert dct.FORWARD_DCT_KERNEL.launches == before
    with pytest.raises(port.UhdrError):
        dct.forward_plane(plane.to("meta"), q)
