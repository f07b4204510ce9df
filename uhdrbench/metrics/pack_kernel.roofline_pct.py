"""Pack (``csrc/pack_kernel.cu`` via ``jpeg/pack_kernel.py``): the share of
the memory roofline that the ``pack_kernel`` launches reach.

Bytes at the stage's interface: the int16 coefficients of every block of
both scans in (each plane padded to whole MCUs), and the entropy-coded
bytes of the two scans of the file each request wrote out (from each SOS
header to its EOI, read from the output of its pool image: the encode is
deterministic, so each request of an image writes those bytes).  The share is the summed bound
over the summed kernel time."""

import struct


def _padded(n, m):
    return -(-n // m) * m


def coefficient_bytes(cfg):
    w, h, k = cfg["width"], cfg["height"], cfg["map_scale"]
    mcu_w, mcu_h = _padded(w, 16), _padded(h, 16)
    c = 3 if cfg["multichannel_map"] else 1
    blocks = mcu_w * mcu_h + 2 * (mcu_w // 2) * (mcu_h // 2) \
        + c * _padded(w // k, 8) * _padded(h // k, 8)
    return 2 * blocks


def entropy_bytes(data: bytes) -> int:
    """Bytes between each SOS header and the next EOI of a JPEG_R."""
    total, pos = 0, 0
    while True:
        sos = data.find(b"\xff\xda", pos)
        if sos < 0:
            return total
        start = sos + 2 + struct.unpack_from(">H", data, sos + 2)[0]
        end = data.find(b"\xff\xd9", start)
        total += end - start
        pos = end + 2


def read(tr):
    ks = tr.kernels("pack_kernel")
    if not ks or not tr.outputs:
        return None
    coef = coefficient_bytes(tr.cfg)
    total = sum(n * (coef + entropy_bytes(o)) for o, n in tr.outputs)
    return 100.0 * total / tr.peak_bytes_per_s / sum(o.seconds for o in ks)
