"""Baseline JPEG header assembly around a device-packed entropy-coded scan.

The host half of ``libultrahdr_tpu/jpeg/encoder.py``: ``assemble_jpeg``
only.  Same stream shape as the reference's JpegEncoderHelper
(jpegencoderhelper.cpp): JFIF APP0, optional ICC APP2, optional gain-map
COM marker (jpegencoderhelper.cpp:204-211), Annex-K tables scaled by
libjpeg's quality rule, baseline sequential scan, default Huffman tables,
and a DRI of one MCU row when the scan carries restart rows.
"""

from __future__ import annotations

import numpy as np

from .. import __version__ as _lib_version
from .tables import AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA, ZIGZAG_ORDER


def _u16(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + _u16(len(payload) + 2) + payload


def _jfif_app0() -> bytes:
    return _segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + _u16(1) + _u16(1)
                    + bytes([0, 0]))


def _dqt(tbl_natural: np.ndarray, table_id: int) -> bytes:
    zz = tbl_natural[ZIGZAG_ORDER]  # natural -> zigzag order
    return _segment(0xDB, bytes([table_id]) + bytes(int(x) for x in zz))


def _sof0(h: int, w: int, comps) -> bytes:
    payload = bytes([8]) + _u16(h) + _u16(w) + bytes([len(comps)])
    for cid, (hs, vs), qtbl in comps:
        payload += bytes([cid, (hs << 4) | vs, qtbl])
    return _segment(0xC0, payload)


def _dht(table, table_class: int, table_id: int) -> bytes:
    return _segment(0xC4, table.dht_payload(table_class, table_id))


def _sos(comps) -> bytes:
    payload = bytes([len(comps)])
    for cid, dc_tbl, ac_tbl in comps:
        payload += bytes([cid, (dc_tbl << 4) | ac_tbl])
    payload += bytes([0, 63, 0])
    return _segment(0xDA, payload)


def _dri(interval: int) -> bytes:
    return _segment(0xDD, _u16(interval))


def assemble_jpeg(h: int, w: int, sampling, qluma, qchroma, scan: bytes,
                  icc: bytes | None = None, gainmap_comment: bool = False,
                  extra_app_segments: list[bytes] | None = None,
                  dri: int = 0) -> bytes:
    """Assemble a full baseline JPEG around an entropy-coded scan."""
    n = len(sampling)
    out = bytearray()
    out += b"\xFF\xD8"
    out += _jfif_app0()
    if icc:
        out += _segment(0xE2, icc)
    if extra_app_segments:
        for seg in extra_app_segments:
            out += seg
    if gainmap_comment:
        comment = (f"Source: google libuhdr v{_lib_version}, "
                   f"Coder: libjpeg v80, Attrib: GainMap Image")
        out += _segment(0xFE, comment.encode("ascii"))
    out += _dqt(qluma, 0)
    if n > 1:
        out += _dqt(qchroma, 1)
    out += _sof0(h, w, [(i + 1, sampling[i], 0 if i == 0 else 1)
                        for i in range(n)])
    out += _dht(DC_LUMA, 0, 0)
    out += _dht(AC_LUMA, 1, 0)
    if n > 1:
        out += _dht(DC_CHROMA, 0, 1)
        out += _dht(AC_CHROMA, 1, 1)
    if dri:
        out += _dri(dri)
    out += _sos([(i + 1, 0 if i == 0 else 1, 0 if i == 0 else 1)
                 for i in range(n)])
    out += scan
    out += b"\xFF\xD9"
    return bytes(out)
