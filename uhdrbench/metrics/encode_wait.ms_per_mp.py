"""Download (``jpeg/pack_kernel.PACK_KERNEL``): milliseconds of the host
blocked on the card in the port's ``encode.wait`` spans per megapixel
encoded: the synchronize before the pack's word count is read, which
waits for the pixel stages, the scan build and the pack still queued, the
card's time as the host sees it."""

NAME = "encode.wait"


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
