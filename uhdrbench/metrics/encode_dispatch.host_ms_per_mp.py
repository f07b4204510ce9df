"""Dispatch (``fused._encode_api0``, ``fused._pack_and_assemble``):
milliseconds of the host in the port's ``encode.dispatch`` spans per
megapixel encoded, less the ``encode.wait`` spans inside them: the time
queuing the eager pixel stages (unpack, tone map, one-pass gain map), the
scan kernel's and the pack kernel's launches, without the wait for the
card before the pack's word count is read."""


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
    got = spans(tr, "encode.dispatch")
    if not got or not tr.megapixels:
        return None
    ids = {s.span_id for s in got}
    waits = [s for s in spans(tr, "encode.wait") if s.parent_id in ids]
    ns = sum(s.end_ns - s.start_ns for s in got) \
        - sum(s.end_ns - s.start_ns for s in waits)
    return 1e-6 * ns / tr.megapixels
