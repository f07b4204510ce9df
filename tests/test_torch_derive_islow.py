"""PyTorch port: ``tools/derive_islow.py`` against the JAX repository's
tool, the port's host C++ and the port's islow IDCT.

- the derived matrix equals ``kIslowM`` as the port's host engine embeds it
  (``libultrahdr_tpu_torch/csrc/host/host_decode.cpp``);
- it equals the JAX tool's ``derive_matrix()`` (the tool loaded by path:
  it imports no JAX), and both tools print the same table;
- ``jpeg/dct.idct8x8_islow`` (+128, ``range_limit``) equals the two-pass
  matrix form bit for bit on 256 seeded dequantised blocks: pass 1
  ``(M @ x + 2^10) >> 11`` down each column, pass 2 ``(M @ y + 2^17) >>
  18`` along each row, both in int32 arithmetic that wraps, then +128 and
  libjpeg's range limit.  The blocks hold coefficients up to +-2047 times
  quantisers up to 255, and DC-only columns and rows (where libjpeg takes
  its shortcuts), DC-only blocks and the extreme values.
"""

import contextlib
import importlib.util
import io
import pathlib
import re

import numpy as np
import torch

from libultrahdr_tpu_torch.jpeg import dct
from libultrahdr_tpu_torch.tools import derive_islow

REPO = pathlib.Path(__file__).resolve().parent.parent
HOST_DECODE = REPO / "libultrahdr_tpu_torch" / "csrc" / "host" / \
    "host_decode.cpp"


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_derive_islow", REPO / "tools" / "derive_islow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _embedded_matrix() -> list[list[int]]:
    text = HOST_DECODE.read_text()
    body = re.search(r"kIslowM\[8\]\[8\]\s*=\s*\{(.*?)\};", text, re.S)
    rows = re.findall(r"\{([^{}]*)\}", body.group(1))
    return [[int(v) for v in row.split(",") if v.strip()] for row in rows]


def test_derived_matrix_equals_the_host_engine_table():
    m = _embedded_matrix()
    assert len(m) == 8 and all(len(r) == 8 for r in m)
    assert derive_islow.derive_matrix() == m
    assert derive_islow.max_basis_error(m) < 2e-4


def test_derived_matrix_equals_the_jax_tool():
    jax_tool = _jax_tool()
    assert derive_islow.derive_matrix() == jax_tool.derive_matrix()
    outs = []
    for main in (derive_islow.main, jax_tool.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def _wrap32(a: np.ndarray) -> np.ndarray:
    return (a + (1 << 31)) % (1 << 32) - (1 << 31)


def _matrix_form(deq: np.ndarray) -> np.ndarray:
    """(n, 8, 8) dequantised blocks [u, v] -> range-limited samples."""
    m = np.asarray(derive_islow.derive_matrix(), np.int64)
    x = deq.astype(np.int64)
    t = _wrap32(np.einsum("ok,nkv->nov", m, x) + (1 << 10)) >> 11
    o = _wrap32(np.einsum("ok,nrk->nro", m, t) + (1 << 17)) >> 18
    s = _wrap32(o + 128) & 1023
    return np.where(s < 256, s, np.where(s < 640, 255, 0))


def _blocks(n: int = 256, seed: int = 18) -> np.ndarray:
    rs = np.random.RandomState(seed)
    coef = rs.randint(-2047, 2048, (n, 8, 8))
    quant = rs.randint(1, 256, (n, 8, 8))
    for i in range(n):
        kind = i % 8
        if kind == 1:        # DC-only columns: pass 1's shortcut
            cols = rs.rand(8) < 0.5
            coef[i, 1:, cols] = 0
        elif kind == 2:      # only column 0: every row DC-only in pass 2
            coef[i, :, 1:] = 0
        elif kind == 3:      # a DC-only block
            coef[i] = 0
            coef[i, 0, 0] = rs.randint(-2047, 2048)
        elif kind == 4:      # sparse, as a real scan's high frequencies
            coef[i] *= rs.rand(8, 8) < 0.15
        elif kind == 5:      # the extremes
            coef[i] = rs.choice([-2047, 2047], (8, 8))
            quant[i] = 255
        elif kind == 6:      # DC-only rows after pass 1 and columns
            coef[i, 1:, :] = 0
    return coef * quant


def test_idct8x8_islow_equals_the_matrix_form():
    deq = _blocks()
    assert np.abs(deq).max() == 2047 * 255
    got = dct.range_limit(dct.idct8x8_islow(
        torch.from_numpy(deq.astype(np.int32))) + 128)
    np.testing.assert_array_equal(got.numpy(), _matrix_form(deq))
