"""The Ultra HDR container, written and read plainly: the MPF APP2 that
locates the gain-map JPEG after the primary (CIPA DC-007), the gain-map
metadata as ISO 21496-1 (APP2) or as Adobe's hdrgm XMP (APP1), and an ICC
profile that states its gamut by a cicp tag.
"""

from __future__ import annotations

import math
import re
import struct
from fractions import Fraction

from .jpeg import segment

XMP_NS = b"http://ns.adobe.com/xap/1.0/\x00"
ISO_NS = b"urn:iso:std:iso:ts:21496:-1\x00"
ICC_ID = b"ICC_PROFILE\x00"
CICP_PRIMARIES = {"BT709": 1, "BT2100": 9, "P3": 12}
CICP_TRANSFER = {"SRGB": 13, "PQ": 16, "HLG": 18}
FIELDS = ("min_boost", "max_boost", "gamma", "offset_sdr", "offset_hdr")


def icc_segment(gamut: str, transfer: str) -> bytes:
    """APP2 ICC_PROFILE holding a 128-byte header, a tag table and one
    cicp tag (ICC.1:2022 10.3)."""
    cicp = b"cicp" + bytes(4) + bytes([CICP_PRIMARIES[gamut],
                                       CICP_TRANSFER[transfer], 0, 1])
    size = 128 + 4 + 12 + len(cicp)
    header = struct.pack(">I", size) + b"uhdr" + bytes([4, 0x40, 0, 0]) \
        + b"mntrRGB XYZ " + bytes(12) + b"acsp"
    header += bytes(128 - len(header))
    body = header + struct.pack(">I", 1) + b"cicp" \
        + struct.pack(">II", 128 + 4 + 12, len(cicp)) + cicp
    return segment(0xE2, ICC_ID + bytes([1, 1]) + body)


def _signed(v: float):
    """The nearest fraction whose numerator and denominator fit int32."""
    limit = (1 << 31) - 1
    f = Fraction(v).limit_denominator(
        max(1, min(limit, int(limit / max(abs(v), 1e-30)))))
    return f.numerator, f.denominator


def iso_payload(meta: dict, hdr_capacity_max: float,
                use_base_cg: bool) -> bytes:
    """ISO 21496-1 metadata (the version block, flags, per-channel
    fractions; no common denominator).  meta: per-channel lists of
    FIELDS."""
    multi = any(len(set(meta[f])) > 1 for f in FIELDS)
    n = 3 if multi else 1
    out = struct.pack(">HHB", 0, 0, (0x80 if multi else 0)
                      | (0x40 if use_base_cg else 0))
    hn, hd = _signed(math.log2(hdr_capacity_max))
    out += struct.pack(">IIII", 0, 1, hn, hd)
    for c in range(n):
        mn = _signed(math.log2(meta["min_boost"][c]))
        mx = _signed(math.log2(meta["max_boost"][c]))
        ga = _signed(meta["gamma"][c])
        bo = _signed(meta["offset_sdr"][c])
        ao = _signed(meta["offset_hdr"][c])
        out += struct.pack(">iIiIIIiIiI", *mn, *mx, *ga, *bo, *ao)
    return ISO_NS + out


def parse_iso(payload: bytes) -> dict:
    """The metadata of an ISO 21496-1 APP2 payload (after its namespace):
    per-channel FIELDS, hdr_capacity_min/max and use_base_cg."""
    _, _, flags = struct.unpack_from(">HHB", payload)
    n = 3 if flags & 0x80 else 1
    pos = 5
    if flags & 0x08:
        den, bn, an = struct.unpack_from(">III", payload, pos)
        pos += 12
        cap = (2 ** (bn / den), 2 ** (an / den))
        rows = []
        for _ in range(n):
            v = struct.unpack_from(">iiIii", payload, pos)
            pos += 20
            rows.append([x / den for x in v])
    else:
        bn, bd, an, ad = struct.unpack_from(">IIII", payload, pos)
        pos += 16
        cap = (2 ** (bn / bd), 2 ** (an / ad))
        rows = []
        for _ in range(n):
            v = struct.unpack_from(">iIiIIIiIiI", payload, pos)
            pos += 40
            rows.append([v[i] / v[i + 1] for i in range(0, 10, 2)])
    rows = [rows[min(c, n - 1)] for c in range(3)]
    meta = {"min_boost": [2 ** r[0] for r in rows],
            "max_boost": [2 ** r[1] for r in rows],
            "gamma": [r[2] for r in rows],
            "offset_sdr": [r[3] for r in rows],
            "offset_hdr": [r[4] for r in rows],
            "hdr_capacity_min": cap[0], "hdr_capacity_max": cap[1],
            "use_base_cg": bool(flags & 0x40)}
    return meta


def xmp_secondary(meta: dict, hdr_capacity_max: float) -> bytes:
    """The gain map's hdrgm XMP (one channel; log2 boosts and
    capacities)."""
    attrs = {
        "Version": "1.0",
        "GainMapMin": repr(math.log2(meta["min_boost"][0])),
        "GainMapMax": repr(math.log2(meta["max_boost"][0])),
        "Gamma": repr(float(meta["gamma"][0])),
        "OffsetSDR": repr(float(meta["offset_sdr"][0])),
        "OffsetHDR": repr(float(meta["offset_hdr"][0])),
        "HDRCapacityMin": "0.0",
        "HDRCapacityMax": repr(math.log2(hdr_capacity_max)),
        "BaseRenditionIsHDR": "False"}
    desc = " ".join(f'hdrgm:{k}="{v}"' for k, v in attrs.items())
    xml = ('<x:xmpmeta xmlns:x="adobe:ns:meta/" x:xmptk="Adobe XMP Core '
           '5.1.2"><rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-'
           'syntax-ns#"><rdf:Description xmlns:hdrgm="http://ns.adobe.com/'
           f'hdr-gain-map/1.0/" {desc}/></rdf:RDF></x:xmpmeta>')
    return XMP_NS + xml.encode()


def xmp_primary(secondary_length: int) -> bytes:
    """The primary's XMP: the hdrgm version and the container directory
    naming the gain map item and its length."""
    xml = ('<x:xmpmeta xmlns:x="adobe:ns:meta/" x:xmptk="Adobe XMP Core '
           '5.1.2"><rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-'
           'syntax-ns#"><rdf:Description xmlns:Container="http://ns.google.'
           'com/photos/1.0/container/" xmlns:Item="http://ns.google.com/'
           'photos/1.0/container/item/" xmlns:hdrgm="http://ns.adobe.com/'
           'hdr-gain-map/1.0/" hdrgm:Version="1.0"><Container:Directory>'
           '<rdf:Seq><rdf:li rdf:parseType="Resource"><Container:Item '
           'Item:Semantic="Primary" Item:Mime="image/jpeg"/></rdf:li>'
           '<rdf:li rdf:parseType="Resource"><Container:Item Item:Semantic='
           f'"GainMap" Item:Mime="image/jpeg" Item:Length="'
           f'{secondary_length}"/></rdf:li></rdf:Seq></Container:Directory>'
           '</rdf:Description></rdf:RDF></x:xmpmeta>')
    return XMP_NS + xml.encode()


def parse_xmp(payload: bytes) -> dict:
    """The hdrgm attributes of a gain map's XMP as metadata."""
    text = payload.decode("utf-8", "replace")

    def get(name, default=None):
        m = re.search(rf'hdrgm:{name}="([^"]*)"', text)
        if m is None:
            if default is None:
                raise ValueError(f"XMP without hdrgm:{name}")
            return default
        return float(m.group(1))
    lo, hi = 2 ** get("GainMapMin", 0.0), 2 ** get("GainMapMax")
    meta = {"min_boost": [lo] * 3, "max_boost": [hi] * 3,
            "gamma": [get("Gamma", 1.0)] * 3,
            "offset_sdr": [get("OffsetSDR", 1 / 64)] * 3,
            "offset_hdr": [get("OffsetHDR", 1 / 64)] * 3,
            "hdr_capacity_min": 2 ** get("HDRCapacityMin", 0.0),
            "hdr_capacity_max": 2 ** get("HDRCapacityMax"),
            "use_base_cg": True}
    return meta


def _mpf(primary_size: int, secondary_size: int,
         secondary_offset: int) -> bytes:
    """MPF APP2 payload, big endian: version, image count, two MP entries
    (offsets relative to the byte after "MPF\\0")."""
    body = b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 3)
    body += struct.pack(">HHI", 0xB000, 7, 4) + b"0100"
    body += struct.pack(">HHII", 0xB001, 4, 1, 2)
    body += struct.pack(">HHII", 0xB002, 7, 32, 8 + 2 + 36 + 4)
    body += struct.pack(">I", 0)
    body += struct.pack(">IIIHH", 0x030000, primary_size, 0, 0, 0)
    body += struct.pack(">IIIHH", 0, secondary_size, secondary_offset, 0, 0)
    return b"MPF\x00" + body


def assemble(primary: bytes, secondary: bytes) -> bytes:
    """primary and secondary are complete JPEGs (SOI first); the MPF APP2
    goes right after the primary's SOI and APPn run, as libultrahdr puts
    it after its own metadata."""
    pos = 2
    while primary[pos] == 0xFF and 0xE0 <= primary[pos + 1] <= 0xEF:
        pos += 2 + struct.unpack_from(">H", primary, pos + 2)[0]
    mpf_len = 4 + len(_mpf(0, 0, 0))
    primary_size = len(primary) + mpf_len
    mpf_at = pos + 8          # the byte after "MPF\0"
    seg = segment(0xE2, _mpf(primary_size, len(secondary),
                             primary_size - mpf_at))
    return primary[:pos] + seg + primary[pos:] + secondary


def split(data: bytes):
    """(primary, gain map) JPEGs located by the primary's MPF APP2;
    raises ValueError where it is missing or points elsewhere."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        m = data[pos + 1]
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + ln]
        if m == 0xE2 and body.startswith(b"MPF\x00"):
            tiff = pos + 8
            bo = ">" if body[4:6] == b"MM" else "<"
            ifd = struct.unpack_from(bo + "I", body, 8)[0]
            count = struct.unpack_from(bo + "H", body, 4 + ifd)[0]
            entries = None
            for i in range(count):
                tag, _, n, off = struct.unpack_from(bo + "HHII", body,
                                                    4 + ifd + 2 + 12 * i)
                if tag == 0xB002:
                    entries = [struct.unpack_from(bo + "IIIHH", body,
                                                  4 + off + 16 * j)
                               for j in range(n // 16)]
            if not entries or len(entries) != 2:
                raise ValueError("MPF without two MP entries")
            p_size = entries[0][1]
            s_size, s_off = entries[1][1], entries[1][2]
            start = tiff + s_off
            sec = data[start:start + s_size]
            if sec[:2] != b"\xFF\xD8" or len(sec) != s_size:
                raise ValueError("MPF entry does not point at a JPEG")
            if p_size != start:
                raise ValueError("primary size disagrees with the MPF")
            return data[:p_size], sec
        if m == 0xDA:
            break
        pos += 2 + ln
    raise ValueError("no MPF APP2 in the primary")


def gainmap_metadata(gm_app) -> dict:
    """The metadata of a gain-map JPEG's APPn list: ISO preferred."""
    for m, body in gm_app:
        if m == 0xE2 and body.startswith(ISO_NS) and len(body) > len(ISO_NS) + 4:
            return parse_iso(body[len(ISO_NS):])
    for m, body in gm_app:
        if m == 0xE1 and body.startswith(XMP_NS):
            return parse_xmp(body[len(XMP_NS):])
    raise ValueError("gain map without ISO or XMP metadata")
