"""Baseline JPEG decoder, host half, plus the device colour conversion.

Port of ``libultrahdr_tpu/jpeg/decoder.py``:

- copied unchanged (host code): ``parse_jpeg`` (segment walk up to SOS with
  the APPn payload extraction of jpegdecoderhelper.cpp:32-44,119-139),
  ``_validate``, ``require_qtable``, ``get_output_sampling_format`` and
  libjpeg's fixed-point YCbCr->RGB tables;
- ported to PyTorch: ``_ycc_to_rgb``, the device twin of libjpeg's fancy
  chroma upsample and fixed-point YCbCr->RGB, in int32 (bit-exact).

The Huffman decode itself is the host native C++ (``native.decode_scan``,
driven by ``decode_coefficients``); the IDCT is ``dct.inverse_plane``.
``decode_to_planes`` (baseline only) chains the two: the host Huffman
decode, a raw upload and the bit-exact IDCT on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import UhdrError, UhdrErrorCode, unsupported
from ..types import ImgFmt
from . import native
from .dct import inverse_plane
from .tables import ZIGZAG_ORDER, HuffTable

MIN_WIDTH = MIN_HEIGHT = 8
MAX_DIMENSION = 8192

EXIF_ID = b"Exif\x00\x00"
XMP_NS = b"http://ns.adobe.com/xap/1.0/\x00"
ICC_SIG = b"ICC_PROFILE\x00"
ISO_NS = b"urn:iso:std:iso:ts:21496:-1\x00"


@dataclasses.dataclass
class ComponentInfo:
    comp_id: int
    h: int
    v: int
    qtbl: int
    dc_tbl: int = 0
    ac_tbl: int = 0


@dataclasses.dataclass
class JpegInfo:
    width: int = 0
    height: int = 0
    num_components: int = 0
    components: list = dataclasses.field(default_factory=list)
    qtables: dict = dataclasses.field(default_factory=dict)
    dc_tables: dict = dataclasses.field(default_factory=dict)
    ac_tables: dict = dataclasses.field(default_factory=dict)
    restart_interval: int = 0
    progressive: bool = False
    scan_offset: int = 0
    scans: list = dataclasses.field(default_factory=list)
    exif: bytes | None = None
    exif_offset: int = -1
    xmp: bytes | None = None
    icc: bytes | None = None
    iso: bytes | None = None


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _skip_entropy(data: bytes, pos: int) -> int:
    """Advance past entropy-coded data to the next true marker (skipping
    stuffed 0xFF00 and RST markers)."""
    n = len(data)
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0 or nxt + 1 >= n:
            return n
        m = data[nxt + 1]
        if m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos = nxt + 1 if m == 0xFF else nxt + 2
            continue
        return nxt


def parse_jpeg(data: bytes, parse_only: bool = False) -> JpegInfo:
    """Walk segments up to (and including) SOS.  Marker payload extraction
    mirrors jpeg_extract_marker_payload (first matching marker wins; the
    stored blob includes the signature prefix, and exif_offset is the
    payload's offset in the source buffer)."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR, "missing SOI")
    info = JpegInfo()
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            # resync like libjpeg's next_marker (jdmarker.c): skip garbage
            # bytes until the next 0xFF — the reference decoder accepts
            # streams with inter-segment junk, so we must too
            nxt = data.find(b"\xff", pos)
            if nxt < 0:
                break
            pos = nxt
            continue
        if data[pos + 1] == 0xFF:  # fill byte (T.81 B.1.1.2)
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD8 or (0xD0 <= marker <= 0xD7) or marker == 0x01:
            pos += 2
            continue
        if marker == 0xD9:  # EOI
            break
        seglen = _u16(data, pos + 2)
        if seglen < 2 or pos + 2 + seglen > n:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            f"truncated segment 0x{marker:02X} at {pos}")
        payload = data[pos + 4: pos + 2 + seglen]
        payload_off = pos + 4
        if marker == 0xC0 or marker == 0xC1 or marker == 0xC2:
            if len(payload) < 6:
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "truncated SOF segment")
            info.progressive = marker == 0xC2
            info.height = _u16(payload, 1)
            info.width = _u16(payload, 3)
            nc = payload[5]
            info.num_components = nc
            if len(payload) < 6 + 3 * nc:
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "truncated SOF component list")
            q = 6
            for _ in range(nc):
                cid = payload[q]
                hv = payload[q + 1]
                info.components.append(
                    ComponentInfo(cid, hv >> 4, hv & 15, payload[q + 2]))
                q += 3
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise unsupported(f"unsupported SOF marker 0x{marker:02X}")
        elif marker == 0xDB:  # DQT
            q = 0
            while q < len(payload):
                pq, tq = payload[q] >> 4, payload[q] & 15
                if tq > 3:  # jdmarker.c get_dqt: JERR_DQT_INDEX
                    raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                    f"bad DQT table index {tq}")
                if q + 1 + (128 if pq else 64) > len(payload):
                    raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                    "truncated DQT segment")
                q += 1
                if pq == 0:
                    zz = np.frombuffer(payload[q:q + 64], np.uint8).astype(np.int32)
                    q += 64
                else:
                    zz = np.frombuffer(payload[q:q + 128], ">u2").astype(np.int32)
                    q += 128
                nat = np.zeros(64, np.int32)
                nat[ZIGZAG_ORDER] = zz  # zigzag payload -> natural order
                info.qtables[tq] = nat
        elif marker == 0xC4:  # DHT
            q = 0
            while q < len(payload):
                tc, th = payload[q] >> 4, payload[q] & 15
                if tc > 1 or th > 3:  # jdmarker.c get_dht: JERR_DHT_INDEX
                    raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                    f"bad DHT index Tc={tc} Th={th}")
                bits = list(payload[q + 1:q + 17])
                nv = sum(bits)
                if nv > 256:  # jdmarker.c get_dht: JERR_BAD_HUFF_TABLE
                    raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                    f"DHT symbol count {nv} > 256")
                if len(bits) < 16 or q + 17 + nv > len(payload):
                    raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                    "truncated DHT segment")
                vals = list(payload[q + 17:q + 17 + nv])
                tbl = HuffTable(bits, vals)
                (info.ac_tables if tc else info.dc_tables)[th] = tbl
                q += 17 + nv
        elif marker == 0xDD:  # DRI
            if len(payload) < 2:
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "truncated DRI segment")
            info.restart_interval = _u16(payload, 0)
        elif marker == 0xE1:  # APP1: EXIF or XMP
            if info.exif is None and payload.startswith(EXIF_ID):
                info.exif = payload
                info.exif_offset = payload_off
            elif info.xmp is None and payload.startswith(XMP_NS):
                info.xmp = payload
        elif marker == 0xE2:  # APP2: ICC or ISO 21496-1
            if info.icc is None and payload.startswith(ICC_SIG):
                info.icc = payload
            elif info.iso is None and payload.startswith(ISO_NS):
                info.iso = payload
        elif marker == 0xDA:  # SOS
            if len(payload) < 1:
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "truncated SOS segment")
            nc = payload[0]
            if len(payload) < 1 + 2 * nc + 3:
                raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                                "truncated SOS component list")
            q = 1
            scan_comps = []
            for _ in range(nc):
                cid = payload[q]
                for ci, comp in enumerate(info.components):
                    if comp.comp_id == cid:
                        comp.dc_tbl = payload[q + 1] >> 4
                        comp.ac_tbl = payload[q + 1] & 15
                        scan_comps.append((ci, comp.dc_tbl, comp.ac_tbl))
                q += 2
            entropy_start = pos + 2 + seglen
            if not info.scans:
                info.scan_offset = entropy_start
            if not info.progressive:
                break
            # progressive: record the scan (with the table set active NOW —
            # DHT may redefine tables between scans) and skip entropy data
            end = _skip_entropy(data, entropy_start)
            info.scans.append({
                "offset": entropy_start, "end": end, "comps": scan_comps,
                "ss": payload[q], "se": payload[q + 1],
                "ah": payload[q + 2] >> 4, "al": payload[q + 2] & 15,
                "dc_tables": dict(info.dc_tables),
                "ac_tables": dict(info.ac_tables),
                "restart_interval": info.restart_interval,
            })
            pos = end
            continue
        pos += 2 + seglen
    if info.width == 0 and not parse_only:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR, "no SOF found")
    return info


def _validate(info: JpegInfo):
    if not (MIN_WIDTH <= info.width <= MAX_DIMENSION
            and MIN_HEIGHT <= info.height <= MAX_DIMENSION):
        raise UhdrError(
            UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE,
            f"jpeg dimensions {info.width}x{info.height} outside "
            f"[{MIN_WIDTH}..{MAX_DIMENSION}]")
    if info.num_components not in (1, 3):
        raise unsupported(f"unsupported component count {info.num_components}")
    for c in info.components:
        require_qtable(info, c)
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise unsupported(f"bad sampling factors {c.h}x{c.v}")


def require_qtable(info: JpegInfo, c):
    """libjpeg parity (jddctmgr.c start_pass: JERR_NO_QUANT_TABLE) — a
    component whose quantization table was never defined is rejected when
    decode begins, not at header parse (jpeg_read_header accepts it)."""
    q = info.qtables.get(c.qtbl)
    if q is None:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        f"component references missing quant table "
                        f"{c.qtbl}")
    return q


def get_output_sampling_format(info: JpegInfo) -> ImgFmt:
    """getOutputSamplingFormat (jpegdecoderhelper.cpp:141-167)."""
    if info.num_components == 1:
        return ImgFmt.YUV400
    h = [c.h for c in info.components]
    v = [c.v for c in info.components]
    if h[1] != h[2] or v[1] != v[2] or h[1] != 1 or v[1] != 1:
        raise unsupported("unsupported chroma sampling")
    key = (h[0], v[0])
    table = {(1, 1): ImgFmt.YUV444, (1, 2): ImgFmt.YUV440,
             (2, 1): ImgFmt.YUV422, (2, 2): ImgFmt.YUV420,
             (4, 1): ImgFmt.YUV411, (4, 2): ImgFmt.YUV410}
    if key not in table:
        raise unsupported(f"unsupported luma sampling {key}")
    return table[key]


def decode_coefficients(data: bytes, info: JpegInfo):
    """Host Huffman decode of a baseline scan to MCU-padded coefficient
    arrays + natural-order quant tables per component (the front half of
    ``decode_to_planes``, without the IDCT)."""
    _validate(info)
    fmt = get_output_sampling_format(info)
    hmax = max(c.h for c in info.components)
    vmax = max(c.v for c in info.components)
    mcus_w = -(-info.width // (8 * hmax))
    mcus_h = -(-info.height // (8 * vmax))
    comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
             for c in info.components]
    dc = [info.dc_tables.get(i) for i in range(4)]
    ac = [info.ac_tables.get(i) for i in range(4)]
    coeffs, _ = native.decode_scan(data[info.scan_offset:], comps, mcus_w,
                                   mcus_h, dc, ac, info.restart_interval)
    qts = [np.asarray(require_qtable(info, c), np.int32)
           for c in info.components]
    return coeffs, qts, fmt


def decode_to_planes(data: bytes, info: JpegInfo | None,
                     device: torch.device):
    """Decode a baseline JPEG to its subsampled YCbCr planes
    (DECODE_TO_YCBCR mode): (u8 tensors on `device`, fmt).  Progressive
    streams raise ``unsupported``."""
    if info is None:
        info = parse_jpeg(data)
    if info.progressive:
        raise unsupported(
            "progressive JPEG decode is not ported yet (ROADMAP.md, Queue 1 "
            "item 9b.3: the general decode path)")
    coeffs, qts, fmt = decode_coefficients(data, info)
    hmax = max(c.h for c in info.components)
    vmax = max(c.v for c in info.components)
    planes = []
    for c, q, comp in zip(coeffs, qts, info.components):
        # stored plane dims: ceil(w*h_i/hmax) x ceil(h*v_i/vmax)
        pw = -(-info.width * comp.h // hmax)
        ph = -(-info.height * comp.v // vmax)
        planes.append(inverse_plane(
            torch.from_numpy(np.ascontiguousarray(c, np.int16)).to(device),
            q, ph, pw))
    return planes, fmt


# libjpeg jdcolor.c ycc_rgb_convert fixed-point tables, SCALEBITS=16,
# FIX(x) = round(x * 65536): the exact integers behind every libjpeg(-turbo)
# RGB decode, i.e. the reference's SRGB/base output and its multichannel
# gain-map decode (jpegdecoderhelper.cpp:353-375).
_JD_IDX = np.arange(256, dtype=np.int64) - 128
YCC_CR_R = ((91881 * _JD_IDX + 32768) >> 16).astype(np.int32)   # FIX(1.40200)
YCC_CB_B = ((116130 * _JD_IDX + 32768) >> 16).astype(np.int32)  # FIX(1.77200)
YCC_CR_G = (-46802 * _JD_IDX).astype(np.int32)                  # -FIX(0.71414)
YCC_CB_G = (-22554 * _JD_IDX + 32768).astype(np.int32)          # -FIX(0.34414)
del _JD_IDX


def _shift_rows(c: torch.Tensor, step: int) -> torch.Tensor:
    """Rows shifted by one with edge replication: row i of the result is
    row clamp(i + step) of `c` (step -1: the row above, +1: below)."""
    if step < 0:
        return torch.cat([c[:1], c[:-1]], dim=0)
    return torch.cat([c[1:], c[-1:]], dim=0)


def _shift_cols(c: torch.Tensor, step: int) -> torch.Tensor:
    if step < 0:
        return torch.cat([c[:, :1], c[:, :-1]], dim=1)
    return torch.cat([c[:, 1:], c[:, -1:]], dim=1)


def _upsample(c: torch.Tensor, fmt_key: str) -> torch.Tensor:
    """libjpeg's chroma upsample (jdsample.c) in int32: h2v2/h2v1 fancy for
    420/422, libjpeg-turbo's h1v2 fancy for 440, replication for 411/410.
    The first/last row and column special cases of the C code equal the
    general formula under edge replication, so this is exact everywhere."""
    def up_h_fancy(c, be, bo, sh):
        # out[2i] = (3c[i] + c[i-1] + be) >> sh; out[2i+1] uses c[i+1], bo
        e = (3 * c + _shift_cols(c, -1) + be) >> sh
        o = (3 * c + _shift_cols(c, 1) + bo) >> sh
        return torch.stack([e, o], dim=-1).reshape(c.shape[0], -1)

    if fmt_key == "420":
        # vertical stage of h2v2 fancy: colsum = 3*nearer + next-nearest
        sums = torch.stack([3 * c + _shift_rows(c, -1),
                            3 * c + _shift_rows(c, 1)],
                           dim=1).reshape(-1, c.shape[1])
        return up_h_fancy(sums, 8, 7, 4)
    if fmt_key == "422":
        return up_h_fancy(c, 1, 2, 2)
    if fmt_key == "440":
        return torch.stack([(3 * c + _shift_rows(c, -1) + 1) >> 2,
                            (3 * c + _shift_rows(c, 1) + 2) >> 2],
                           dim=1).reshape(-1, c.shape[1])
    if fmt_key == "411":
        return torch.repeat_interleave(c, 4, dim=1)
    if fmt_key == "410":
        return torch.repeat_interleave(
            torch.repeat_interleave(c, 2, dim=0), 4, dim=1)
    return c  # 444


def _ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                fmt_key: str, h: int, w: int) -> torch.Tensor:
    """Bit-exact libjpeg RGB decode of u8 planes on their device: fancy
    chroma upsample + jdcolor fixed-point YCbCr->RGB, all int32 (``>>`` on
    int32 is arithmetic).  Returns (3, h, w) uint8."""
    dev = y.device
    yi = y[:h, :w].to(torch.int32)
    cbu = _upsample(cb.to(torch.int32), fmt_key)[:h, :w].to(torch.int64)
    cru = _upsample(cr.to(torch.int32), fmt_key)[:h, :w].to(torch.int64)
    lut = {name: torch.from_numpy(t).to(dev) for name, t in (
        ("cr_r", YCC_CR_R), ("cb_b", YCC_CB_B), ("cr_g", YCC_CR_G),
        ("cb_g", YCC_CB_G))}
    r = yi + lut["cr_r"][cru]
    g = yi + ((lut["cb_g"][cbu] + lut["cr_g"][cru]) >> 16)
    b = yi + lut["cb_b"][cbu]
    return torch.clamp(torch.stack([r, g, b]), 0, 255).to(torch.uint8)
