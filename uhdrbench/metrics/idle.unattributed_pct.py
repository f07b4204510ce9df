"""Host outside the port's layers: the share of the card's idle time in
the traced window that no span below a ``decode`` span covers on any
thread (``decode.parse``, ``.huffman``, ``.upload``, ``.dispatch``,
``.wait``, ``.download``): the part of each request that no layer's metric
names, from the device trace's gaps and the port's spans."""

from uhdrbench import trace


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint (start,
    end) intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(tr):
    from libultrahdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans") or not tr.device_ops:
        return None
    w0, w1 = tr.window
    below = [(max(s.start_ns * 1e-9, w0), min(s.end_ns * 1e-9, w1))
             for s in profiling.spans() if s.name.startswith("decode.")]
    below = [(s, e) for s, e in below if e > s]
    idle = trace.gaps([(o.start, o.end) for o in tr.device_ops], w0, w1)
    idle_s = sum(e - s for s, e in idle)
    if not below or idle_s <= 0:
        return None
    return 100.0 * (idle_s - overlap(idle, _merged(below))) / idle_s
