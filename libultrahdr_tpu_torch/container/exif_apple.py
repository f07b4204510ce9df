"""Apple EXIF MakerNote HDR headroom extraction.

Direct port of getExifAppleHeadroom
(lib/src/jpegrutils.cpp:512-644): walk TIFF IFDs, enter the
"Apple iOS" MakerNote (always big-endian), read signed-rational tags 33/48
and apply Apple's piecewise stops formula; headroom = 2^stops.

A copy of the JAX package's ``container/exif_apple.py`` (host code, the
same in every line of code), which ``container/xmp.py`` imports.
"""

from __future__ import annotations

import struct

APPLE_MAKER_HEADER = b"Apple iOS\x00\x00\x01MM"


def _rd(exif: bytes, offset: int, fmt_be: str, fmt_le: str, big: bool):
    fmt = fmt_be if big else fmt_le
    size = struct.calcsize(fmt)
    if offset + size > len(exif):
        return None
    return struct.unpack_from(fmt, exif, offset)[0]


def get_exif_apple_headroom(exif: bytes) -> float | None:
    """Returns headroom (linear) or None if not present/parseable."""
    size = len(exif)
    offset = 0
    if size >= 6 and exif[:6] == b"Exif\x00\x00":
        offset = 6
    else:
        # find TIFF header II*\0 / MM\0*
        found = False
        for i in range(max(0, size - 3)):
            if exif[i:i + 4] in (b"II\x2a\x00", b"MM\x00\x2a"):
                offset = i
                found = True
                break
        if not found:
            return None
    if offset + 4 > size:
        return None
    big = exif[offset:offset + 1] == b"M"
    offset += 4
    offset_to_ifd = _rd(exif, offset, ">I", "<I", big)
    if offset_to_ifd is None:
        return None
    offset += 4
    tiff_header_offset = offset - 8

    in_apple = False
    has_value = False
    maker33 = 0.0
    maker48 = 0.0
    num_ifds = 0

    while offset_to_ifd != 0 and num_ifds < 3:
        num_ifds += 1
        offset = tiff_header_offset + offset_to_ifd
        next_set = False
        field_count = _rd(exif, offset, ">H", "<H", big)
        if field_count is None:
            return None
        offset += 2
        for _ in range(field_count):
            vals = []
            for f_be, f_le, sz in ((">H", "<H", 2), (">H", "<H", 2),
                                   (">I", "<I", 4), (">I", "<I", 4)):
                v = _rd(exif, offset, f_be, f_le, big)
                if v is None:
                    return None
                vals.append(v)
                offset += sz
            tag_id, data_format, _num, tag_data = vals
            if tag_id == 0x8769:  # Exif sub-IFD
                offset_to_ifd = tag_data
                next_set = True
                break
            if tag_id == 0x927C:  # MakerNote
                mk = tiff_header_offset + tag_data
                if exif[mk:mk + len(APPLE_MAKER_HEADER)] == APPLE_MAKER_HEADER:
                    offset_to_ifd = tag_data + len(APPLE_MAKER_HEADER)
                    in_apple = True
                    next_set = True
                    big = True  # Apple MakerNotes are always big endian
                    break
            elif in_apple and tag_id in (33, 48) and data_format == 10:
                base = tiff_header_offset + offset_to_ifd
                if base < len(APPLE_MAKER_HEADER):
                    return None
                tmp = base - len(APPLE_MAKER_HEADER) + tag_data
                num = _rd(exif, tmp, ">i", "<i", big)
                den = _rd(exif, tmp + 4, ">I", "<I", big)
                if num is None or den is None:
                    return None
                if den != 0:
                    v = num / den
                    if tag_id == 33:
                        maker33 = v
                    else:
                        maker48 = v
                    has_value = True
        if not next_set:
            nxt = _rd(exif, offset, ">I", "<I", big)
            if nxt is None:
                return None
            offset_to_ifd = nxt
            offset += 4

    if not has_value:
        return None
    if maker33 < 1.0:
        stops = -20.0 * maker48 + 1.8 if maker48 <= 0.01 else -0.101 * maker48 + 1.601
    else:
        stops = -70.0 * maker48 + 3.0 if maker48 <= 0.01 else -0.303 * maker48 + 2.303
    return 2.0 ** stops
