"""Host Huffman decode (``jpeg/native.decode_scan``, C++): milliseconds of
the host's entropy decode per megapixel decoded, from the
``uhdrbench.host_huffman`` spans of the traced run."""


def read(tr):
    spans = tr.host_spans("uhdrbench.host_huffman")
    if not spans or not tr.megapixels:
        return None
    return 1e3 * sum(e - s for _, _, s, e in spans) / tr.megapixels
