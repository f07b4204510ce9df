"""Host join (``fused.fetch_blocks_multi`` over ``jpeg/native.join_blocks``,
C++): milliseconds of the host in the port's ``encode.join`` spans (one a
scan, base and map) per megapixel encoded."""

NAME = "encode.join"


def spans(tr, name):
    """The port's spans called `name` (``utils.profiling.spans()``) that
    overlap the traced window; None from a port that records none."""
    from libultrahdr_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None
    w0, w1 = tr.window
    return [s for s in profiling.spans() if s.name == name
            and s.start_ns * 1e-9 < w1 and s.end_ns * 1e-9 > w0]


def read(tr):
    got = spans(tr, NAME)
    if not got or not tr.megapixels:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got) / tr.megapixels
