"""Baseline JPEG encoder: device DCT/quant, host Huffman, header assembly.

Port of ``libultrahdr_tpu/jpeg/encoder.py``.  Same stream shape as the
reference's JpegEncoderHelper (jpegencoderhelper.cpp): JFIF APP0, optional
ICC APP2, optional gain-map COM marker (jpegencoderhelper.cpp:204-211),
Annex-K tables scaled by libjpeg's quality rule, sampling factors per input
format (jpegencoderhelper.cpp:26-43), baseline sequential scan, default
Huffman tables, and a DRI of one MCU row when the scan carries restart
rows (the fused encodes' scans; the general path's have none).

- ``assemble_jpeg``: the headers around an entropy-coded scan, shared by
  the fused encodes (a device-packed scan) and the general path;
- ``JpegEncoder.compress``: the general path: MCU pad and ``forward_plane``
  on the device, the coefficients to the host and the host entropy coder
  (``native.encode_scan``), as the JAX package does, so the bytes equal its
  own whenever the coefficients do.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import __version__ as _lib_version
from ..errors import invalid_param
from ..ops.pixel import plane_tensor
from ..types import ImgFmt, RawImage
from . import native
from .dct import forward_plane, pad_edge, rgb_to_ycbcr
from .tables import (AC_CHROMA, AC_LUMA, DC_CHROMA, DC_LUMA, STD_CHROMA_QUANT,
                     STD_LUMA_QUANT, ZIGZAG_ORDER, scaled_quant_table)

_FMT_SAMPLING = {
    ImgFmt.YUV400: [(1, 1)],
    ImgFmt.YUV444: [(1, 1), (1, 1), (1, 1)],
    ImgFmt.YUV440: [(1, 2), (1, 1), (1, 1)],
    ImgFmt.YUV422: [(2, 1), (1, 1), (1, 1)],
    ImgFmt.YUV420: [(2, 2), (1, 1), (1, 1)],
    ImgFmt.YUV411: [(4, 1), (1, 1), (1, 1)],
    ImgFmt.YUV410: [(4, 2), (1, 1), (1, 1)],
    ImgFmt.RGB888: [(1, 1), (1, 1), (1, 1)],  # converted to YCbCr 444
}


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


class JpegEncoder:
    """Stateless baseline JPEG compressor for the formats the codec needs,
    computing its DCT on `device`."""

    def __init__(self, device: torch.device):
        self.device = device

    def compress(self, img: RawImage, quality: int, icc: bytes | None = None,
                 gainmap_comment: bool = False,
                 extra_app_segments: list[bytes] | None = None) -> bytes:
        """One baseline JPEG of `img` (planes on the host or on the
        device), without restart markers."""
        fmt = ImgFmt(img.fmt)
        if fmt not in _FMT_SAMPLING:
            raise invalid_param(
                f"unrecognized input format for jpeg encode: {fmt}")
        if img.w > 65535 or img.h > 65535:
            raise invalid_param("image too large for jpeg")
        sampling = _FMT_SAMPLING[fmt]
        hmax = max(s[0] for s in sampling)
        vmax = max(s[1] for s in sampling)
        mcus_w = -(-img.w // (8 * hmax))
        mcus_h = -(-img.h // (8 * vmax))
        if fmt == ImgFmt.RGB888:
            planes = rgb_to_ycbcr(plane_tensor(
                img.planes[0], self.device).permute(2, 0, 1))
        else:
            planes = [plane_tensor(p, self.device)
                      for p in img.planes[:len(sampling)]]
        n = len(sampling)
        quality = int(quality)
        qluma = scaled_quant_table(STD_LUMA_QUANT, quality)
        qchroma = scaled_quant_table(STD_CHROMA_QUANT, quality)
        comps = []
        for i, (hs, vs) in enumerate(sampling):
            padded = pad_edge(planes[i], mcus_h * vs * 8, mcus_w * hs * 8)
            coeffs = forward_plane(padded, qluma if i == 0 else qchroma)
            comps.append({"coeffs": coeffs.cpu().numpy(), "h": hs, "v": vs,
                          "dc_tbl": int(i > 0), "ac_tbl": int(i > 0)})
        dc_tables = [DC_LUMA, DC_CHROMA if n > 1 else None, None, None]
        ac_tables = [AC_LUMA, AC_CHROMA if n > 1 else None, None, None]
        scan = native.encode_scan(comps, mcus_w, mcus_h, dc_tables, ac_tables)
        return assemble_jpeg(img.h, img.w, sampling, qluma, qchroma, scan,
                             icc=icc, gainmap_comment=gainmap_comment,
                             extra_app_segments=extra_app_segments)
