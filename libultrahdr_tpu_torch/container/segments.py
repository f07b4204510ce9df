"""JPEG stream scanner: split a JPEG_R container into its image ranges.

Copy of ``libultrahdr_tpu/container/segments.py`` (host code, unchanged).
It replaces the vendored image_io JpegScanner/JpegInfoBuilder usage
(jpegr.cpp:1701-1768): find up to `limit` SOI..EOI
image ranges in a byte stream (primary image + gain map image), walking
segment headers and entropy-coded data safely.
"""

from __future__ import annotations

from ..errors import UhdrError, UhdrErrorCode

SOI = 0xD8
EOI = 0xD9
SOS = 0xDA


def _skip_entropy(data: bytes, pos: int) -> int:
    """Advance past entropy-coded data to the next real marker (not RSTn,
    not stuffed 0xFF00).  Returns position of the 0xFF of that marker."""
    n = len(data)
    while pos < n:
        idx = data.find(b"\xFF", pos)
        if idx < 0 or idx + 1 >= n:
            return n
        m = data[idx + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos = idx + 2 if m != 0xFF else idx + 1
            continue
        return idx
    return n


def scan_jpeg_images(data: bytes, limit: int = 2) -> list[tuple[int, int]]:
    """Find up to `limit` complete JPEG images; returns [(start, end)] byte
    ranges (end exclusive, includes EOI).  The final image may be truncated
    (missing EOI) — its range extends to the end of the buffer, matching the
    scanner's lenient behavior with appended streams."""
    ranges = []
    n = len(data)
    pos = 0
    while pos + 1 < n and len(ranges) < limit:
        # find SOI
        while pos + 1 < n and not (data[pos] == 0xFF and data[pos + 1] == SOI):
            pos += 1
        if pos + 1 >= n:
            break
        start = pos
        pos += 2
        end = None
        while pos + 1 < n:
            if data[pos] != 0xFF:
                # tolerate garbage: resync to next marker
                idx = data.find(b"\xFF", pos)
                if idx < 0:
                    break
                pos = idx
                continue
            marker = data[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            if marker == EOI:
                end = pos + 2
                break
            if marker == SOI:
                # unexpected nested SOI: end previous image here
                end = pos
                break
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if pos + 4 > n:
                break
            seglen = (data[pos + 2] << 8) | data[pos + 3]
            pos += 2 + seglen
            if marker == SOS:
                pos = _skip_entropy(data, pos)
        if end is None:
            end = n
        ranges.append((start, end))
        pos = end
    if not ranges:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        "no jpeg image found in buffer")
    return ranges
