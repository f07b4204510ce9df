"""Download, into which memory: the percentage of the window's
``decode.download`` spans (``jpegr._download``, output and gain map) whose
``pinned`` is true, a copy into a pinned block of PyTorch's caching host
allocator, against a pageable ``.cpu()``.  None from a port whose spans
carry no ``pinned``."""


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
    got = [s for s in spans(tr, "decode.download") or ()
           if "pinned" in s.attrs]
    if not got:
        return None
    return 100.0 * sum(bool(s.attrs["pinned"]) for s in got) / len(got)
