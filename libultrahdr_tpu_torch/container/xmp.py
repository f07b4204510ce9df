"""XMP gain-map metadata (Adobe hdrgm schema): generate + parse.

Re-implements generateXmpFor{Primary,Secondary}Image and getMetadataFromXMP
(lib/src/jpegrutils.cpp:876-939, 646-874), byte-compatible
with image_io's XmlWriter formatting (third_party/image_io/src/xml/
xml_writer.cc): 2-space indent, one attribute per line, '/>' self-close.

Gain map min/max and HDR capacities are stored in log2 space; gamma and
offsets linear.  Parsing accepts attribute-style hdrgm values, applies the
reference's defaults (min=1.0, gamma=1.0, offsets=1/64, capacity_min=1.0),
and supports the Apple HDRGainMap namespace fallback.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..errors import UhdrError, UhdrErrorCode, unsupported
from ..types import GainMapMetadata

XMP_NAMESPACE = "http://ns.adobe.com/xap/1.0/"
GAINMAP_URI = "http://ns.adobe.com/hdr-gain-map/1.0/"
CONTAINER_URI = "http://ns.google.com/photos/1.0/container/"
ITEM_URI = "http://ns.google.com/photos/1.0/container/item/"
APPLE_GAINMAP_URI_FRAGMENT = "apple"
JPEGR_VERSION = "1.0"


def _fmt(v) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    if isinstance(v, str):
        return v
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return f"{float(v):.6g}"


class _XmlWriter:
    """Python mirror of image_io::XmlWriter (xml_writer.cc)."""

    def __init__(self):
        self.out = []
        self.indent = ""
        self.stack = []  # [name, has_attrs, has_children, has_content]

    def _maybe_close_bracket(self, newline: bool):
        if self.stack and not self.stack[-1][2] and not self.stack[-1][3]:
            self.out.append(">")
            if newline:
                self.out.append("\n")

    def start_element(self, name: str) -> int:
        self._maybe_close_bracket(True)
        depth = len(self.stack)
        if self.stack:
            self.stack[-1][2] = True
        self.stack.append([name, False, False, False])
        self.out.append(f"{self.indent}<{name}")
        self.indent += "  "
        return depth

    def attribute(self, name: str, value, quote=True):
        self.out.append(f"\n{self.indent}{name}=")
        v = _fmt(value)
        self.out.append(f'"{v}"' if quote or True else v)
        self.stack[-1][1] = True

    def xmlns(self, prefix: str, uri: str):
        self.attribute(f"xmlns:{prefix}", uri)

    def finish_element(self):
        if not self.stack:
            return
        self.indent = self.indent[:-2]
        name, has_attrs, has_children, has_content = self.stack.pop()
        if not has_content and not has_children:
            if not has_attrs or has_children:
                self.out.append(self.indent)
            self.out.append("/>\n")
        else:
            if not has_content:
                self.out.append(self.indent)
            self.out.append(f"</{name}>\n")

    def finish_to_depth(self, depth: int):
        while len(self.stack) > depth:
            self.finish_element()

    def finish(self):
        self.finish_to_depth(0)

    def result(self) -> str:
        return "".join(self.out)


def generate_xmp_for_secondary_image(metadata: GainMapMetadata) -> str:
    """generateXmpForSecondaryImage (jpegrutils.cpp:915-939)."""
    w = _XmlWriter()
    w.start_element("x:xmpmeta")
    w.xmlns("x", "adobe:ns:meta/")
    w.attribute("x:xmptk", "Adobe XMP Core 5.1.2")
    w.start_element("rdf:RDF")
    w.xmlns("rdf", "http://www.w3.org/1999/02/22-rdf-syntax-ns#")
    w.start_element("rdf:Description")
    w.xmlns("hdrgm", GAINMAP_URI)
    w.attribute("hdrgm:Version", JPEGR_VERSION)
    w.attribute("hdrgm:GainMapMin", math.log2(float(metadata.min_content_boost[0])))
    w.attribute("hdrgm:GainMapMax", math.log2(float(metadata.max_content_boost[0])))
    w.attribute("hdrgm:Gamma", float(metadata.gamma[0]))
    w.attribute("hdrgm:OffsetSDR", float(metadata.offset_sdr[0]))
    w.attribute("hdrgm:OffsetHDR", float(metadata.offset_hdr[0]))
    w.attribute("hdrgm:HDRCapacityMin", math.log2(float(metadata.hdr_capacity_min)))
    w.attribute("hdrgm:HDRCapacityMax", math.log2(float(metadata.hdr_capacity_max)))
    w.attribute("hdrgm:BaseRenditionIsHDR", "False")
    w.finish()
    return w.result()


def generate_xmp_for_primary_image(secondary_image_length: int,
                                   metadata: GainMapMetadata) -> str:
    """generateXmpForPrimaryImage (jpegrutils.cpp:876-913)."""
    w = _XmlWriter()
    w.start_element("x:xmpmeta")
    w.xmlns("x", "adobe:ns:meta/")
    w.attribute("x:xmptk", "Adobe XMP Core 5.1.2")
    w.start_element("rdf:RDF")
    w.xmlns("rdf", "http://www.w3.org/1999/02/22-rdf-syntax-ns#")
    w.start_element("rdf:Description")
    w.xmlns("Container", CONTAINER_URI)
    w.xmlns("Item", ITEM_URI)
    w.xmlns("hdrgm", GAINMAP_URI)
    w.attribute("hdrgm:Version", JPEGR_VERSION)
    w.start_element("Container:Directory")
    w.start_element("rdf:Seq")
    item_depth = w.start_element("rdf:li")
    w.attribute("rdf:parseType", "Resource")
    w.start_element("Container:Item")
    w.attribute("Item:Semantic", "Primary")
    w.attribute("Item:Mime", "image/jpeg")
    w.finish_to_depth(item_depth)
    w.start_element("rdf:li")
    w.attribute("rdf:parseType", "Resource")
    w.start_element("Container:Item")
    w.attribute("Item:Semantic", "GainMap")
    w.attribute("Item:Mime", "image/jpeg")
    w.attribute("Item:Length", int(secondary_image_length))
    w.finish()
    return w.result()


# ---------------------------------------------------------------------------
# Parsing: a real XML tokenizer + the reference's XMPXmlHandler state machine
# (jpegrutils.cpp:109-433).  The tokenizer understands comments, CDATA,
# processing instructions, DOCTYPE, both quote styles, and entity references,
# so hostile XMP (hdrgm attributes inside comments, rebound prefixes, CDATA
# tricks) tokenizes the same way image_io's XmlReader does instead of being
# regex-scraped.


class _XmlError(ValueError):
    """Malformed XML -> the reference's 'xml parser returned with error'
    (UHDR_CODEC_UNKNOWN_ERROR, jpegrutils.cpp:716-723)."""


_NAME_RE = re.compile(r"[A-Za-z_:][\w:.\-]*")
_ENTITY_RE = re.compile(r"&(#x[0-9A-Fa-f]+|#\d+|amp|lt|gt|quot|apos);")
_WS = " \t\r\n"


def _decode_entities(s: str) -> str:
    def sub(m):
        e = m.group(1)
        if e == "amp":
            return "&"
        if e == "lt":
            return "<"
        if e == "gt":
            return ">"
        if e == "quot":
            return '"'
        if e == "apos":
            return "'"
        try:
            return chr(int(e[2:], 16) if e[1] in "xX" else int(e[1:]))
        except (ValueError, OverflowError):
            raise _XmlError(f"bad character reference &{e};")
    return _ENTITY_RE.sub(sub, s)


def _tokenize_xml(xml: str):
    """Yields ('start', name, [(attr, value), ...]) | ('end', name) |
    ('text', data) events.  Raises _XmlError on malformed markup."""
    i, n = 0, len(xml)
    while i < n:
        lt = xml.find("<", i)
        if lt < 0:
            yield ("text", xml[i:])
            return
        if lt > i:
            yield ("text", xml[i:lt])
        if xml.startswith("<!--", lt):
            end = xml.find("-->", lt + 4)
            if end < 0:
                raise _XmlError("unterminated comment")
            i = end + 3
            continue
        if xml.startswith("<![CDATA[", lt):
            end = xml.find("]]>", lt + 9)
            if end < 0:
                raise _XmlError("unterminated CDATA section")
            yield ("text", xml[lt + 9:end])
            i = end + 3
            continue
        if xml.startswith("<!", lt):
            end = xml.find(">", lt)  # DOCTYPE etc.
            if end < 0:
                raise _XmlError("unterminated declaration")
            i = end + 1
            continue
        if xml.startswith("<?", lt):
            end = xml.find("?>", lt + 2)
            if end < 0:
                raise _XmlError("unterminated processing instruction")
            i = end + 2
            continue
        if xml.startswith("</", lt):
            end = xml.find(">", lt)
            if end < 0:
                raise _XmlError("unterminated end tag")
            name = xml[lt + 2:end].strip()
            if not _NAME_RE.fullmatch(name):
                raise _XmlError(f"malformed end tag </{name}>")
            yield ("end", name)
            i = end + 1
            continue
        m = _NAME_RE.match(xml, lt + 1)
        if not m:
            raise _XmlError("malformed start tag")
        name = m.group(0)
        j = m.end()
        attrs = []
        while True:
            while j < n and xml[j] in _WS:
                j += 1
            if j >= n:
                raise _XmlError(f"unterminated start tag <{name}")
            if xml[j] == ">":
                yield ("start", name, attrs)
                i = j + 1
                break
            if xml.startswith("/>", j):
                yield ("start", name, attrs)
                yield ("end", name)
                i = j + 2
                break
            m = _NAME_RE.match(xml, j)
            if not m:
                raise _XmlError(f"malformed attribute in <{name}>")
            aname = m.group(0)
            j = m.end()
            while j < n and xml[j] in _WS:
                j += 1
            if j >= n or xml[j] != "=":
                raise _XmlError(f"attribute {aname} without value")
            j += 1
            while j < n and xml[j] in _WS:
                j += 1
            if j >= n or xml[j] not in "\"'":
                raise _XmlError(f"unquoted value for attribute {aname}")
            q = xml[j]
            end = xml.find(q, j + 1)
            if end < 0:
                raise _XmlError(f"unterminated value for attribute {aname}")
            attrs.append((aname, _decode_entities(xml[j + 1:end])))
            j = end + 1


_CONTAINER_NAME = "rdf:Description"  # XMPXmlHandler::containerName
_HDRGM_ATTRS = frozenset(
    "hdrgm:" + k for k in ("Version", "GainMapMin", "GainMapMax", "Gamma",
                           "OffsetSDR", "OffsetHDR", "HDRCapacityMin",
                           "HDRCapacityMax", "BaseRenditionIsHDR"))
_APPLE_VERSION = "HDRGainMapVersion"
_APPLE_HEADROOM = "HDRGainMapHeadroom"


def _collect_hdrgm(xml: str) -> dict:
    """XMPXmlHandler state machine (jpegrutils.cpp:109-433): parsing arms on
    an rdf:Description element; while armed, attributes are matched by their
    literal hdrgm:-qualified names and child elements whose names contain
    the Apple HDRGainMap markers capture element content; the first
    childless finish of the container disarms it."""
    state = 0           # 0 NotStarted, 1 Started, 2 Done
    last_elem = ""      # lastElementName
    fields: dict = {}
    apple = False
    stack: list = []
    for ev in _tokenize_xml(xml):
        if ev[0] == "start":
            name, attrs = ev[1], ev[2]
            stack.append(name)
            if name == _CONTAINER_NAME:
                state = 1
            elif state == 1:
                if _APPLE_VERSION in name:
                    last_elem = _APPLE_VERSION
                elif _APPLE_HEADROOM in name:
                    last_elem = _APPLE_HEADROOM
                else:
                    last_elem = "Unknown"
            elif state != 2:
                state = 0
            if state == 1:
                for aname, aval in attrs:
                    if aname in _HDRGM_ATTRS:
                        fields[aname.split(":", 1)[1]] = aval
        elif ev[0] == "end":
            if not stack or stack[-1] != ev[1]:
                raise _XmlError(f"mismatched end tag </{ev[1]}>")
            stack.pop()
            if state == 1:
                if not last_elem:
                    state = 2
                else:
                    last_elem = ""
        else:  # text
            if state == 1 and last_elem in (_APPLE_VERSION, _APPLE_HEADROOM):
                val = ev[1].strip()
                if val:
                    fields[last_elem] = val
                    if last_elem == _APPLE_VERSION:
                        apple = True
    if stack:
        raise _XmlError(f"unclosed element <{stack[-1]}>")
    return {"fields": fields, "apple": apple}


_FLOAT_PREFIX_RE = re.compile(
    r"[ \t\r\n]*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[+-]?(?:inf(?:inity)?|nan))", re.IGNORECASE)


def _parse_float_cxx(s: str):
    """istream >> float semantics (the getters at jpegrutils.cpp:260-370):
    leading whitespace skipped, longest valid prefix parsed, trailing
    garbage ignored; None when no prefix parses."""
    m = _FLOAT_PREFIX_RE.match(s)
    if not m:
        return None
    try:
        return float(m.group(1))
    except ValueError:
        return None


def strip_xmp_packet(payload: bytes) -> str:
    """Remove the APP1 namespace header + optional xpacket wrapper
    (getMetadataFromXMP, jpegrutils.cpp:668-707)."""
    ns = XMP_NAMESPACE.encode() + b"\x00"
    if payload.startswith(XMP_NAMESPACE.encode()):
        payload = payload[len(ns):]
    start = 0
    for i in range(len(payload) - 1):
        if payload[i:i + 1] == b"<" and payload[i + 1:i + 2] != b"?":
            start = i
            break
    end = len(payload)
    for i in range(len(payload) - 1, 0, -1):
        if payload[i:i + 1] == b">" and payload[i - 1:i] != b"?":
            end = i + 1
            break
    return payload[start:end].decode("utf-8", errors="replace")


def parse_xmp_metadata(payload: bytes, exif: bytes | None = None) -> GainMapMetadata:
    """getMetadataFromXMP (jpegrutils.cpp:646-874).

    Raises UhdrError on missing required fields.  Apple gain maps resolve
    headroom from HDRGainMapHeadroom or the EXIF Apple MakerNote."""
    xml = strip_xmp_packet(payload)
    try:
        parsed = _collect_hdrgm(xml)
    except _XmlError:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_UNKNOWN_ERROR,
                        "xml parser returned with error")
    f = parsed["fields"]
    md = GainMapMetadata()

    if parsed["apple"]:
        md.gamma[:] = 1.0
        md.min_content_boost[:] = 1.0
        md.offset_sdr[:] = 0.0
        md.offset_hdr[:] = 0.0
        md.hdr_capacity_min = 1.0
        # getMaxContentBoost applies exp2 (jpegrutils.cpp:255-265); a
        # present-but-unparseable headroom falls through to the EXIF
        # MakerNote path like the reference's && chain (jpegrutils.cpp:735).
        headroom = None
        if "HDRGainMapHeadroom" in f:
            v = _parse_float_cxx(f["HDRGainMapHeadroom"])
            if v is not None:
                headroom = 2.0 ** v
        if headroom is None and exif is not None:
            from .exif_apple import get_exif_apple_headroom
            headroom = get_exif_apple_headroom(exif)
        if headroom is None:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "could not find attribute HDRGainMapHeadroom and "
                            "Exif Headroom missing")
        md.max_content_boost[:] = headroom
        md.hdr_capacity_max = headroom
        md.use_base_cg = True
        return md

    if "Version" not in f:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        "xml parse error, could not find attribute hdrgm:Version")

    def required_log2(key):
        # absent OR unparseable both report 'could not find' (the getters
        # return false either way at jpegrutils.cpp:775-790)
        v = _parse_float_cxx(f[key]) if key in f else None
        if v is None:
            raise UhdrError(
                UhdrErrorCode.UHDR_CODEC_ERROR,
                f"xml parse error, could not find attribute hdrgm:{key}")
        return 2.0 ** v

    def optional(key, default, log2: bool):
        # absent -> default; present-but-unparseable -> parse error
        # (jpegrutils.cpp:793-860)
        if key not in f:
            return default
        v = _parse_float_cxx(f[key])
        if v is None:
            raise UhdrError(
                UhdrErrorCode.UHDR_CODEC_ERROR,
                f"xml parse error, unable to parse attribute hdrgm:{key}")
        return 2.0 ** v if log2 else v

    md.max_content_boost[:] = required_log2("GainMapMax")
    md.hdr_capacity_max = required_log2("HDRCapacityMax")
    md.min_content_boost[:] = optional("GainMapMin", 1.0, log2=True)
    md.gamma[:] = optional("Gamma", 1.0, log2=False)
    md.offset_sdr[:] = optional("OffsetSDR", 1.0 / 64.0, log2=False)
    md.offset_hdr[:] = optional("OffsetHDR", 1.0 / 64.0, log2=False)
    md.hdr_capacity_min = optional("HDRCapacityMin", 1.0, log2=True)
    base_is_hdr = f.get("BaseRenditionIsHDR", "False")
    if base_is_hdr not in ("True", "False"):
        raise UhdrError(
            UhdrErrorCode.UHDR_CODEC_ERROR,
            "xml parse error, unable to parse attribute "
            "hdrgm:BaseRenditionIsHDR")
    if base_is_hdr == "True":
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        "hdr intent as base rendition is not supported")
    md.use_base_cg = True
    return md
