"""Host join (``jpeg/native.join_blocks``, C++): milliseconds of the
host's restart-row join per megapixel encoded, from the
``uhdrbench.host_join`` spans of the traced run."""


def read(tr):
    spans = tr.host_spans("uhdrbench.host_join")
    if not spans or not tr.megapixels:
        return None
    return 1e3 * sum(e - s for _, _, s, e in spans) / tr.megapixels
