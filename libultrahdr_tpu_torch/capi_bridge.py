"""Marshaling layer for a C ABI shim.

Port of ``libultrahdr_tpu/capi_bridge.py``, the layer that an
embedded-CPython shim (the JAX package's capi/uhdr_capi.cpp) calls, here on
top of the port's encoder and decoder: ``enc_new`` and ``dec_new`` take
``device="cuda"`` (the card unless the caller asks for the CPU; a CUDA
request without a GPU raises).  It keeps the shim's C++ side free of numpy
and of any per-format layout knowledge: every function takes scalars,
bytes or raw pointer addresses and returns scalars or tuples of bytes.
Plane geometry (ultrahdr_api.h:212-231 plane conventions) lives in one
place, `_plane_geometry`, shared by the copy-in and copy-out directions.

Pointer reads use ctypes `from_address`, so the C caller's buffers are
copied exactly once, at set_raw_image time (the reference also deep-copies
raw image descriptors into its context, ultrahdr_api.cpp:815-1031).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import api
from .errors import UhdrError, UhdrErrorCode
from .jpegr import is_uhdr_image  # noqa: F401  (the shim calls it by name)
from .types import (ColorGamut, ColorRange, ColorTransfer, CompressedImage,
                    GainMapMetadata, ImgFmt, ImgLabel, RawImage)

_DTYPES = {np.uint8: ctypes.c_uint8, np.uint16: ctypes.c_uint16,
           np.uint32: ctypes.c_uint32}


def _plane_geometry(fmt: ImgFmt, w: int, h: int):
    """[(rows, row_pixels, dtype, elems_per_pixel)] per plane for fmt."""
    f = ImgFmt(fmt)
    if f == ImgFmt.P010:
        return [(h, w, np.uint16, 1), (h // 2, w, np.uint16, 1)]
    if f == ImgFmt.YUV420:
        return [(h, w, np.uint8, 1), (h // 2, w // 2, np.uint8, 1),
                (h // 2, w // 2, np.uint8, 1)]
    if f == ImgFmt.YUV422:
        return [(h, w, np.uint8, 1), (h, w // 2, np.uint8, 1),
                (h, w // 2, np.uint8, 1)]
    if f == ImgFmt.YUV440:
        return [(h, w, np.uint8, 1), (h // 2, w, np.uint8, 1),
                (h // 2, w, np.uint8, 1)]
    if f == ImgFmt.YUV444:
        return [(h, w, np.uint8, 1)] * 3
    if f == ImgFmt.YUV444_10:
        return [(h, w, np.uint16, 1)] * 3
    if f == ImgFmt.YUV400:
        return [(h, w, np.uint8, 1)]
    if f in (ImgFmt.RGBA8888, ImgFmt.RGBA1010102):
        return [(h, w, np.uint32, 1)]
    if f == ImgFmt.RGBAF16:
        return [(h, w, np.uint16, 4)]
    if f == ImgFmt.RGB888:
        return [(h, w, np.uint8, 3)]
    raise UhdrError(UhdrErrorCode.UHDR_CODEC_INVALID_PARAM,
                    f"unsupported image format {fmt}")


def _read_planes(fmt: ImgFmt, w: int, h: int, addrs, strides):
    """Copy C plane buffers (pointer addresses + pixel strides) into
    contiguous numpy arrays."""
    planes = []
    for (rows, rowpix, dt, epp), addr, stride in zip(
            _plane_geometry(fmt, w, h), addrs, strides):
        if not addr:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_INVALID_PARAM,
                            "received nullptr for image plane")
        stride = stride or rowpix
        if stride < rowpix:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_INVALID_PARAM,
                            f"stride {stride} < width {rowpix}")
        n = rows * stride * epp
        buf = (_DTYPES[dt] * n).from_address(addr)
        arr = np.frombuffer(buf, dtype=dt).reshape(rows, stride, epp)
        arr = np.ascontiguousarray(arr[:, :rowpix, :])
        planes.append(arr.reshape((rows, rowpix) if epp == 1
                                  else (rows, rowpix, epp)).copy())
    return planes


# ---------------------------------------------------------------------------
# encoder

def enc_new(device="cuda"):
    return api.UhdrEncoder(device=device)


def enc_set_raw_image(enc, fmt, cg, ct, rng, w, h, addrs, strides, intent):
    img = RawImage(ImgFmt(fmt), ColorGamut(cg), ColorTransfer(ct),
                   ColorRange(rng), int(w), int(h),
                   _read_planes(ImgFmt(fmt), int(w), int(h), addrs, strides))
    enc.set_raw_image(img, ImgLabel(intent))


def enc_set_compressed_image(enc, data: bytes, cg, ct, rng, intent):
    enc.set_compressed_image(
        CompressedImage(data, ColorGamut(cg), ColorTransfer(ct),
                        ColorRange(rng)), ImgLabel(intent))


def _meta_from_flat(vals):
    """19 floats + 1 int (3x5 channel arrays, 2 scalars, use_base_cg)."""
    m = GainMapMetadata()
    m.max_content_boost[:] = vals[0:3]
    m.min_content_boost[:] = vals[3:6]
    m.gamma[:] = vals[6:9]
    m.offset_sdr[:] = vals[9:12]
    m.offset_hdr[:] = vals[12:15]
    m.hdr_capacity_min = float(vals[15])
    m.hdr_capacity_max = float(vals[16])
    m.use_base_cg = bool(vals[17])
    return m


def meta_to_flat(m: GainMapMetadata):
    return (tuple(float(x) for x in m.max_content_boost)
            + tuple(float(x) for x in m.min_content_boost)
            + tuple(float(x) for x in m.gamma)
            + tuple(float(x) for x in m.offset_sdr)
            + tuple(float(x) for x in m.offset_hdr)
            + (float(m.hdr_capacity_min), float(m.hdr_capacity_max),
               int(m.use_base_cg)))


def enc_set_gainmap_image(enc, data: bytes, cg, ct, rng, meta_vals):
    enc.set_gainmap_image(
        CompressedImage(data, ColorGamut(cg), ColorTransfer(ct),
                        ColorRange(rng)), _meta_from_flat(meta_vals))


def enc_get_stream(enc):
    return enc.get_encoded_stream()


# ---------------------------------------------------------------------------
# decoder

def dec_new(device="cuda"):
    return api.UhdrDecoder(device=device)


def dec_set_image(dec, data: bytes):
    dec.set_image(data)


def dec_get_gainmap_metadata_flat(dec):
    m = dec.get_gainmap_metadata()
    return None if m is None else meta_to_flat(m)


def _image_out(img: RawImage | None):
    """RawImage -> (fmt, cg, ct, rng, w, h, (plane bytes...), (strides...))
    with strides in pixels; None passes through."""
    if img is None:
        return None
    planes = [np.ascontiguousarray(p) for p in img.planes]
    strides = [p.shape[1] for p in planes]
    return (int(img.fmt), int(img.cg), int(img.ct), int(img.range),
            int(img.w), int(img.h),
            tuple(p.tobytes() for p in planes), tuple(strides))


def dec_get_decoded_image(dec):
    return _image_out(dec.get_decoded_image())


def dec_get_gainmap_image_raw(dec):
    return _image_out(dec.get_decoded_gainmap_image())


# ---------------------------------------------------------------------------
# shared

def error_tuple(exc) -> tuple:
    """Exception -> (code:int, detail:str) for uhdr_error_info_t."""
    if isinstance(exc, UhdrError):
        return int(exc.code), str(exc.detail or "")
    return int(UhdrErrorCode.UHDR_CODEC_UNKNOWN_ERROR), repr(exc)
