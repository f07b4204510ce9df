"""Download (``fused._pack_and_assemble``): milliseconds of the host in the
port's ``encode.download`` spans per megapixel encoded: the D2H copies of
the packed words and the block lengths, after the ``encode.wait``."""

NAME = "encode.download"


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
