"""JPEG_R container assembly: primary + gain map + metadata in one stream.

Re-implements JpegR::appendGainMap's byte layout
(lib/src/jpegr.cpp:1053-1330):

    SOI | [APP1 EXIF] | [APP1 XMP-primary] | [APP2 ICC] |
    APP2 ISO-version | APP2 MPF | primary-sans-SOI |
    SOI | [APP1 XMP-secondary] | APP2 ISO-metadata | gainmap-sans-SOI

MPF offsets are computed exactly as the reference does (secondary offset
relative to the byte after the MPF signature).
"""

from __future__ import annotations

from ..errors import unsupported
from ..types import GainMapMetadata
from . import iso21496, mpf, xmp

XMP_NS = b"http://ns.adobe.com/xap/1.0/\x00"
ISO_NS = b"urn:iso:std:iso:ts:21496:-1\x00"

# CMake option defaults (CMakeLists.txt:115-136): ISO on, XMP off.
WRITE_ISO_METADATA = True
WRITE_XMP_METADATA = False


def _marker_segment(marker: int, payload: bytes) -> bytes:
    length = len(payload) + 2
    return bytes([0xFF, marker, (length >> 8) & 0xFF, length & 0xFF]) + payload


def append_gainmap(primary_jpeg: bytes, gainmap_jpeg: bytes,
                   metadata: GainMapMetadata, exif: bytes | None = None,
                   icc: bytes | None = None,
                   write_iso: bool | None = None,
                   write_xmp: bool | None = None) -> bytes:
    """Assemble the JPEG_R stream.  `exif` is the raw TIFF blob including the
    "Exif\\0\\0" identifier; `icc` includes the ICC_PROFILE prefix."""
    write_iso = WRITE_ISO_METADATA if write_iso is None else write_iso
    write_xmp = WRITE_XMP_METADATA if write_xmp is None else write_xmp
    if not (write_iso or write_xmp):
        raise unsupported("at least one of ISO/XMP metadata must be written")
    if write_xmp and not metadata.use_base_cg:
        raise unsupported("gainmap application space as alternate image space "
                          "is not supported in xmp mode")
    if write_xmp and not metadata.are_all_channels_identical():
        raise unsupported("multichannel gainmap metadata in xmp mode "
                          "is not supported")

    # secondary image prologue
    secondary_parts = []
    if write_xmp:
        xmp_secondary = xmp.generate_xmp_for_secondary_image(metadata).encode()
        secondary_parts.append(_marker_segment(0xE1, XMP_NS + xmp_secondary))
    if write_iso:
        frac = iso21496.float_to_fraction(metadata)
        iso_payload = iso21496.encode_gainmap_metadata(frac)
        secondary_parts.append(_marker_segment(0xE2, ISO_NS + iso_payload))
    secondary_image_size = len(gainmap_jpeg) + sum(len(p) for p in secondary_parts)

    out = bytearray()
    out += b"\xFF\xD8"  # SOI
    if exif is not None:
        out += _marker_segment(0xE1, exif)
    if write_xmp:
        xmp_primary = xmp.generate_xmp_for_primary_image(
            secondary_image_size, metadata).encode()
        out += _marker_segment(0xE1, XMP_NS + xmp_primary)
    if icc is not None:
        out += _marker_segment(0xE2, icc)
    if write_iso:
        out += _marker_segment(0xE2, ISO_NS + b"\x00\x00\x00\x00")

    # MPF (jpegr.cpp:1265-1283)
    mpf_payload_len = 2 + mpf.calculate_mpf_size()
    pos = len(out)
    primary_image_size = pos + 2 + mpf_payload_len + (len(primary_jpeg) - 2)
    secondary_image_offset = primary_image_size - pos - 8
    mpf_data = mpf.generate_mpf(primary_image_size, 0,
                                secondary_image_size, secondary_image_offset)
    out += _marker_segment(0xE2, mpf_data)

    out += primary_jpeg[2:]       # primary sans SOI
    out += b"\xFF\xD8"            # secondary SOI
    for p in secondary_parts:
        out += p
    out += gainmap_jpeg[2:]       # gainmap sans SOI
    return bytes(out)
