"""Host join, where it runs: the percentage of the window's
``encode.join`` spans whose ``engine`` is ``"device"``, the join of a fused
encode's scans on the card (``jpeg/join_kernel``), against ``"host"``
(``native.join_blocks``).  None from a port whose spans carry no
``engine``."""


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
    got = [s for s in spans(tr, "encode.join") or ()
           if "engine" in s.attrs]
    if not got:
        return None
    return 100.0 * sum(s.attrs["engine"] == "device" for s in got) / len(got)
