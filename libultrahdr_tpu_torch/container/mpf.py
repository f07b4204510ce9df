"""CIPA DC-007 Multi-Picture Format APP2 payload.

Byte-exact re-implementation of generateMpf/calculateMpfSize
(lib/src/multipictureformat.cpp:14-85, constants
multipictureformat.h:37-64).  Big-endian (the reference default,
USE_BIG_ENDIAN_IN_MPF=true).
"""

from __future__ import annotations

import struct

MPF_SIG = b"MPF\x00"
MP_BIG_ENDIAN = bytes([0x4D, 0x4D, 0x00, 0x2A])
VERSION_TAG = 0xB000
VERSION_TYPE = 0x7          # UNDEFINED
VERSION_COUNT = 4
VERSION_EXPECTED = b"0100"
NUMBER_OF_IMAGES_TAG = 0xB001
NUMBER_OF_IMAGES_TYPE = 0x4  # LONG
MP_ENTRY_TAG = 0xB002
MP_ENTRY_TYPE = 0x7
MP_ENTRY_SIZE = 16
NUM_PICTURES = 2
TAG_SERIALIZED_COUNT = 3
TAG_SIZE = 12
MP_ENDIAN_SIZE = 4
ATTRIBUTE_TYPE_PRIMARY = 0x030000
ATTRIBUTE_FORMAT_JPEG = 0x0000000


def calculate_mpf_size() -> int:
    return (len(MPF_SIG) + MP_ENDIAN_SIZE + 4 + 2
            + TAG_SERIALIZED_COUNT * TAG_SIZE + 4 + NUM_PICTURES * MP_ENTRY_SIZE)


def generate_mpf(primary_image_size: int, primary_image_offset: int,
                 secondary_image_size: int, secondary_image_offset: int) -> bytes:
    out = bytearray()
    out += MPF_SIG
    out += MP_BIG_ENDIAN
    index_ifd_offset = MP_ENDIAN_SIZE + len(MPF_SIG)
    out += struct.pack(">I", index_ifd_offset)
    out += struct.pack(">H", TAG_SERIALIZED_COUNT)
    # version tag
    out += struct.pack(">HHI", VERSION_TAG, VERSION_TYPE, VERSION_COUNT)
    out += VERSION_EXPECTED
    # number of images
    out += struct.pack(">HHII", NUMBER_OF_IMAGES_TAG, NUMBER_OF_IMAGES_TYPE,
                       1, NUM_PICTURES)
    # MP entries tag header; value offset is relative to the endianness field
    out += struct.pack(">HHI", MP_ENTRY_TAG, MP_ENTRY_TYPE,
                       MP_ENTRY_SIZE * NUM_PICTURES)
    mp_entry_offset = len(out) - len(MPF_SIG) + 4 + 4
    out += struct.pack(">I", mp_entry_offset)
    out += struct.pack(">I", 0)  # attribute IFD offset (not written)
    # primary entry
    out += struct.pack(">III", ATTRIBUTE_FORMAT_JPEG | ATTRIBUTE_TYPE_PRIMARY,
                       primary_image_size, primary_image_offset)
    out += struct.pack(">HH", 0, 0)
    # secondary entry
    out += struct.pack(">III", ATTRIBUTE_FORMAT_JPEG,
                       secondary_image_size, secondary_image_offset)
    out += struct.pack(">HH", 0, 0)
    assert len(out) == calculate_mpf_size()
    return bytes(out)
