"""Scan build (``csrc/dct_kernel.cu`` via ``jpeg/dct.py``): the share of
the memory roofline that the ``scan_kernel`` launches reach.

Bytes are counted at the stage's interface from each request's shapes:
the 8-bit SDR planes (Y and, 4:2:0, two quarter-size chroma planes) and
the 8-bit map samples in, int16 coefficients of every block out, each
plane padded to whole MCUs.  The bound is those bytes over the card's
bandwidth; the share is the summed bound over the summed kernel time."""


def _padded(n, m):
    return -(-n // m) * m


def scan_bytes(cfg):
    w, h, k = cfg["width"], cfg["height"], cfg["map_scale"]
    mcu_w, mcu_h = _padded(w, 16), _padded(h, 16)
    base = w * h + 2 * (w // 2) * (h // 2)
    base_blocks = mcu_w * mcu_h + 2 * (mcu_w // 2) * (mcu_h // 2)
    c = 3 if cfg["multichannel_map"] else 1
    mw, mh = w // k, h // k
    gm = c * mw * mh
    gm_blocks = c * _padded(mw, 8) * _padded(mh, 8)
    return base + gm + 2 * (base_blocks + gm_blocks)


def read(tr):
    ks = tr.kernels("scan_kernel")
    if not ks or not tr.requests:
        return None
    bound = len(tr.requests) * scan_bytes(tr.cfg) / tr.peak_bytes_per_s
    return 100.0 * bound / sum(o.seconds for o in ks)
