"""ISO 21496-1 gain map metadata: fraction struct + binary encode/decode.

Byte-exact re-implementation of uhdr_gainmap_metadata_frac
(lib/src/gainmapmetadata.cpp:112-424) and the
continued-fraction float<->rational conversion
(gainmapmath.cpp:1620-1684).  Big-endian fields; flags bit7=multichannel,
bit6=use-base-colorspace, bit2=backward-direction, bit3=common-denominator.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np

from ..errors import UhdrError, UhdrErrorCode, invalid_param, unsupported
from ..types import GainMapMetadata

IS_MULTICHANNEL_MASK = 1 << 7
USE_BASE_COLORSPACE_MASK = 1 << 6
BACKWARD_DIRECTION_MASK = 1 << 2
COMMON_DENOMINATOR_MASK = 1 << 3

UINT32_MAX = 0xFFFFFFFF
INT32_MAX = 0x7FFFFFFF


def float_to_unsigned_fraction(v: float, max_numerator: int = UINT32_MAX):
    """floatToUnsignedFractionImpl (gainmapmath.cpp:1620-1669): best rational
    approximation by continued fractions.  Returns (num, den) or None."""
    if math.isnan(v) or v < 0 or v > max_numerator:
        return None
    max_d = UINT32_MAX if v <= 1 else math.floor(max_numerator / v)
    denominator = 1
    previous_d = 0
    current_v = float(v) - math.floor(v)
    numerator = 0
    for _ in range(39):
        numerator_double = float(denominator) * v
        if numerator_double > max_numerator:
            return None
        numerator = int(round(numerator_double))
        if abs(numerator_double - numerator) == 0.0:
            return numerator, denominator
        current_v = 1.0 / current_v
        new_d = previous_d + math.floor(current_v) * denominator
        if new_d > max_d:
            return numerator, denominator
        previous_d = denominator
        if new_d > UINT32_MAX:
            return None
        denominator = int(new_d)
        current_v -= math.floor(current_v)
    numerator = int(round(float(denominator) * v))
    return numerator, denominator


def float_to_signed_fraction(v: float):
    """floatToSignedFraction (gainmapmath.cpp:1671-1681)."""
    r = float_to_unsigned_fraction(abs(v), INT32_MAX)
    if r is None:
        return None
    n, d = r
    return (-n if v < 0 else n), d


@dataclasses.dataclass
class FractionMetadata:
    """uhdr_gainmap_metadata_frac (gainmapmetadata.h:25-89)."""

    gain_map_min_n: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    gain_map_min_d: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    gain_map_max_n: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    gain_map_max_d: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    gain_map_gamma_n: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    gain_map_gamma_d: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    base_offset_n: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    base_offset_d: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    alternate_offset_n: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    alternate_offset_d: list = dataclasses.field(default_factory=lambda: [1, 1, 1])
    base_hdr_headroom_n: int = 0
    base_hdr_headroom_d: int = 1
    alternate_hdr_headroom_n: int = 0
    alternate_hdr_headroom_d: int = 1
    backward_direction: bool = False
    use_base_color_space: bool = True

    def all_channels_identical(self) -> bool:
        def same(xs):
            return xs[0] == xs[1] == xs[2]
        return all(same(x) for x in [
            self.gain_map_min_n, self.gain_map_min_d, self.gain_map_max_n,
            self.gain_map_max_d, self.gain_map_gamma_n, self.gain_map_gamma_d,
            self.base_offset_n, self.base_offset_d, self.alternate_offset_n,
            self.alternate_offset_d])


def encode_gainmap_metadata(m: FractionMetadata) -> bytes:
    """encodeGainmapMetadata (gainmapmetadata.cpp:112-192)."""
    out = bytearray()
    out += struct.pack(">HH", 0, 0)  # min_version, writer_version
    channel_count = 1 if m.all_channels_identical() else 3
    flags = 0
    if channel_count == 3:
        flags |= IS_MULTICHANNEL_MASK
    if m.use_base_color_space:
        flags |= USE_BASE_COLORSPACE_MASK
    if m.backward_direction:
        flags |= BACKWARD_DIRECTION_MASK
    denom = m.base_hdr_headroom_d
    use_common = (m.base_hdr_headroom_d == denom
                  and m.alternate_hdr_headroom_d == denom)
    for c in range(channel_count):
        if (m.gain_map_min_d[c] != denom or m.gain_map_max_d[c] != denom
                or m.gain_map_gamma_d[c] != denom or m.base_offset_d[c] != denom
                or m.alternate_offset_d[c] != denom):
            use_common = False
    if use_common:
        flags |= COMMON_DENOMINATOR_MASK
    out += struct.pack(">B", flags)
    if use_common:
        out += struct.pack(">III", denom, m.base_hdr_headroom_n,
                           m.alternate_hdr_headroom_n)
        for c in range(channel_count):
            out += struct.pack(">iiIii", m.gain_map_min_n[c], m.gain_map_max_n[c],
                               m.gain_map_gamma_n[c], m.base_offset_n[c],
                               m.alternate_offset_n[c])
    else:
        out += struct.pack(">IIII", m.base_hdr_headroom_n, m.base_hdr_headroom_d,
                           m.alternate_hdr_headroom_n, m.alternate_hdr_headroom_d)
        for c in range(channel_count):
            out += struct.pack(">iIiIIIiIiI",
                               m.gain_map_min_n[c], m.gain_map_min_d[c],
                               m.gain_map_max_n[c], m.gain_map_max_d[c],
                               m.gain_map_gamma_n[c], m.gain_map_gamma_d[c],
                               m.base_offset_n[c], m.base_offset_d[c],
                               m.alternate_offset_n[c], m.alternate_offset_d[c])
    return bytes(out)


def decode_gainmap_metadata(data: bytes) -> FractionMetadata:
    """decodeGainmapMetadata (gainmapmetadata.cpp:194-289)."""
    def need(n, pos):
        if pos + n > len(data):
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "iso 21496-1 metadata truncated")
    pos = 0
    need(5, pos)
    min_version, writer_version = struct.unpack_from(">HH", data, 0)
    if min_version != 0:
        raise unsupported(
            f"received unexpected minimum version {min_version}, expected 0")
    flags = data[4]
    pos = 5
    channel_count = 3 if (flags & IS_MULTICHANNEL_MASK) else 1
    m = FractionMetadata()
    m.use_base_color_space = bool(flags & USE_BASE_COLORSPACE_MASK)
    m.backward_direction = bool(flags & BACKWARD_DIRECTION_MASK)
    use_common = bool(flags & COMMON_DENOMINATOR_MASK)

    if use_common:
        need(12, pos)
        denom, m.base_hdr_headroom_n, m.alternate_hdr_headroom_n = \
            struct.unpack_from(">III", data, pos)
        pos += 12
        m.base_hdr_headroom_d = m.alternate_hdr_headroom_d = denom
        for c in range(channel_count):
            need(20, pos)
            (m.gain_map_min_n[c], m.gain_map_max_n[c], m.gain_map_gamma_n[c],
             m.base_offset_n[c], m.alternate_offset_n[c]) = \
                struct.unpack_from(">iiIii", data, pos)
            pos += 20
            m.gain_map_min_d[c] = m.gain_map_max_d[c] = denom
            m.gain_map_gamma_d[c] = m.base_offset_d[c] = denom
            m.alternate_offset_d[c] = denom
    else:
        need(16, pos)
        (m.base_hdr_headroom_n, m.base_hdr_headroom_d,
         m.alternate_hdr_headroom_n, m.alternate_hdr_headroom_d) = \
            struct.unpack_from(">IIII", data, pos)
        pos += 16
        for c in range(channel_count):
            need(40, pos)
            (m.gain_map_min_n[c], m.gain_map_min_d[c],
             m.gain_map_max_n[c], m.gain_map_max_d[c],
             m.gain_map_gamma_n[c], m.gain_map_gamma_d[c],
             m.base_offset_n[c], m.base_offset_d[c],
             m.alternate_offset_n[c], m.alternate_offset_d[c]) = \
                struct.unpack_from(">iIiIIIiIiI", data, pos)
            pos += 40
    for c in range(channel_count, 3):
        for field in ["gain_map_min", "gain_map_max", "gain_map_gamma",
                      "base_offset", "alternate_offset"]:
            getattr(m, field + "_n")[c] = getattr(m, field + "_n")[0]
            getattr(m, field + "_d")[c] = getattr(m, field + "_d")[0]
    return m


def fraction_to_float(m: FractionMetadata) -> GainMapMetadata:
    """gainmapMetadataFractionToFloat (gainmapmetadata.cpp:300-346)."""
    for name, arr in [("gainMapMax", m.gain_map_max_d),
                      ("gainMapGamma", m.gain_map_gamma_d),
                      ("gainMapMin", m.gain_map_min_d),
                      ("baseOffset", m.base_offset_d),
                      ("alternateOffset", m.alternate_offset_d)]:
        for d in arr:
            if d == 0:
                raise invalid_param(f"received 0 (bad value) for field {name} denominator")
    if m.base_hdr_headroom_d == 0 or m.alternate_hdr_headroom_d == 0:
        raise invalid_param("received 0 (bad value) for hdr headroom denominator")
    if m.backward_direction:
        raise unsupported("hdr intent as base rendition is not supported")
    md = GainMapMetadata()
    for i in range(3):
        md.max_content_boost[i] = 2.0 ** (np.float32(m.gain_map_max_n[i]) / m.gain_map_max_d[i])
        md.min_content_boost[i] = 2.0 ** (np.float32(m.gain_map_min_n[i]) / m.gain_map_min_d[i])
        md.gamma[i] = np.float32(m.gain_map_gamma_n[i]) / m.gain_map_gamma_d[i]
        md.offset_sdr[i] = np.float32(m.base_offset_n[i]) / m.base_offset_d[i]
        md.offset_hdr[i] = np.float32(m.alternate_offset_n[i]) / m.alternate_offset_d[i]
    md.hdr_capacity_max = float(
        2.0 ** (np.float32(m.alternate_hdr_headroom_n) / m.alternate_hdr_headroom_d))
    md.hdr_capacity_min = float(
        2.0 ** (np.float32(m.base_hdr_headroom_n) / m.base_hdr_headroom_d))
    md.use_base_cg = m.use_base_color_space
    return md


def float_to_fraction(md: GainMapMetadata) -> FractionMetadata:
    """gainmapMetadataFloatToFraction (gainmapmetadata.cpp:348-424)."""
    m = FractionMetadata()
    m.backward_direction = False
    m.use_base_color_space = bool(md.use_base_cg)

    def signed(v):
        r = float_to_signed_fraction(float(v))
        if r is None:
            raise invalid_param(
                f"error representing float {v} as a rational number")
        return r

    def unsigned(v):
        r = float_to_unsigned_fraction(float(v))
        if r is None:
            raise invalid_param(
                f"error representing float {v} as a rational number")
        return r

    single = md.are_all_channels_identical()
    for i in range(1 if single else 3):
        m.gain_map_max_n[i], m.gain_map_max_d[i] = signed(
            np.log2(np.float32(md.max_content_boost[i])))
        m.gain_map_min_n[i], m.gain_map_min_d[i] = signed(
            np.log2(np.float32(md.min_content_boost[i])))
        m.gain_map_gamma_n[i], m.gain_map_gamma_d[i] = unsigned(md.gamma[i])
        m.base_offset_n[i], m.base_offset_d[i] = signed(md.offset_sdr[i])
        m.alternate_offset_n[i], m.alternate_offset_d[i] = signed(md.offset_hdr[i])
    if single:
        for field in ["gain_map_min", "gain_map_max", "gain_map_gamma",
                      "base_offset", "alternate_offset"]:
            for c in (1, 2):
                getattr(m, field + "_n")[c] = getattr(m, field + "_n")[0]
                getattr(m, field + "_d")[c] = getattr(m, field + "_d")[0]
    m.base_hdr_headroom_n, m.base_hdr_headroom_d = unsigned(
        np.log2(np.float32(md.hdr_capacity_min)))
    m.alternate_hdr_headroom_n, m.alternate_hdr_headroom_d = unsigned(
        np.log2(np.float32(md.hdr_capacity_max)))
    return m
