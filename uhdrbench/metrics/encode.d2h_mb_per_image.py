"""Download (``fused._pack_and_assemble``): megabytes (1e6 B) that the
D2H copies of an encode bring to host memory per request, the ``bytes``
counters of the port's ``encode.download`` spans (the pack's live words
and its block lengths) over the requests of the traced run."""


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
    got = spans(tr, "encode.download")
    if not got or not tr.requests:
        return None
    return 1e-6 * sum(s.attrs["bytes"] for s in got) / len(tr.requests)
