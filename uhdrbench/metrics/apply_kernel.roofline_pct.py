"""Apply (``csrc/apply_kernel.cu`` via ``ops/apply_kernel.py``): the share
of the memory roofline that the ``apply_gainmap_kernel`` launches reach.

Bytes at the stage's interface: the decoded 8-bit base samples (Y and two
quarter-size chroma planes) and the stored 8-bit map in, the 4-byte
RGBA1010102 output pixels out.  The share is the summed bound over the
summed kernel time."""


def apply_bytes(cfg):
    w, h, k = cfg["width"], cfg["height"], cfg["map_scale"]
    c = 3 if cfg["multichannel_map"] else 1
    return (w * h + 2 * (w // 2) * (h // 2) + c * (w // k) * (h // k)
            + 4 * w * h)


def read(tr):
    ks = tr.kernels("apply_gainmap_kernel")
    if not ks or not tr.requests:
        return None
    bound = len(tr.requests) * apply_bytes(tr.cfg) / tr.peak_bytes_per_s
    return 100.0 * bound / sum(o.seconds for o in ks)
