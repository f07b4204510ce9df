"""ctypes mirrors of ``ultrahdr_tpu.h`` for a Python caller of the shim.

``load`` opens the shim built for a running interpreter
(``build.build_shim(linked=False)``) with ``ctypes.CDLL`` and binds the
entry points below; ``encode_p010`` and ``decode`` drive one API-0 request
and one decode through them, as a C caller would.  ctypes releases the GIL
around each call and the shim takes it back, so several Python threads
may call through their own handles at once.
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

from ..errors import UhdrError, UhdrErrorCode
from ..types import ColorGamut, ColorRange, ColorTransfer, ImgFmt, ImgLabel

_int = ctypes.c_int     # every enum of the header is int-sized


class ErrorInfo(ctypes.Structure):
    """uhdr_error_info_t."""
    _fields_ = [("error_code", _int), ("has_detail", _int),
                ("detail", ctypes.c_char * 256)]


class RawImage(ctypes.Structure):
    """uhdr_raw_image_t (strides in pixels)."""
    _fields_ = [("fmt", _int), ("cg", _int), ("ct", _int), ("range", _int),
                ("w", ctypes.c_uint), ("h", ctypes.c_uint),
                ("planes", ctypes.c_void_p * 3),
                ("stride", ctypes.c_uint * 3)]


class CompressedImage(ctypes.Structure):
    """uhdr_compressed_image_t."""
    _fields_ = [("data", ctypes.c_void_p), ("data_sz", ctypes.c_size_t),
                ("capacity", ctypes.c_size_t), ("cg", _int), ("ct", _int),
                ("range", _int)]


_codec = ctypes.c_void_p     # uhdr_codec_private_t*
SIGNATURES = {               # entry point -> (restype, argtypes)
    "uhdr_create_encoder": (_codec, []),
    "uhdr_release_encoder": (None, [_codec]),
    "uhdr_enc_set_raw_image": (ErrorInfo,
                               [_codec, ctypes.POINTER(RawImage), _int]),
    "uhdr_enc_set_quality": (ErrorInfo, [_codec, _int, _int]),
    "uhdr_enc_set_using_multi_channel_gainmap": (ErrorInfo, [_codec, _int]),
    "uhdr_enc_set_gainmap_scale_factor": (ErrorInfo, [_codec, _int]),
    "uhdr_encode": (ErrorInfo, [_codec]),
    "uhdr_get_encoded_stream": (ctypes.POINTER(CompressedImage), [_codec]),
    "uhdr_create_decoder": (_codec, []),
    "uhdr_release_decoder": (None, [_codec]),
    "uhdr_dec_set_image": (ErrorInfo,
                           [_codec, ctypes.POINTER(CompressedImage)]),
    "uhdr_dec_set_out_img_format": (ErrorInfo, [_codec, _int]),
    "uhdr_dec_set_out_color_transfer": (ErrorInfo, [_codec, _int]),
    "uhdr_decode": (ErrorInfo, [_codec]),
    "uhdr_get_decoded_image": (ctypes.POINTER(RawImage), [_codec]),
}


def load(path: pathlib.Path) -> ctypes.CDLL:
    """The shim at `path` with SIGNATURES bound."""
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def check(err: ErrorInfo, what: str):
    """Raise the UhdrError a non-OK uhdr_error_info_t carries."""
    if err.error_code != UhdrErrorCode.UHDR_CODEC_OK:
        raise UhdrError(UhdrErrorCode(err.error_code),
                        f"{what}: {err.detail.decode(errors='replace')}")


def _created(handle, what: str):
    if not handle:
        raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                        f"{what} returned NULL")
    return handle


def encode_p010(lib, y: np.ndarray, uv: np.ndarray, *, scale: int,
                multichannel: bool, quality: int = 95,
                rng: ColorRange = ColorRange.FULL) -> bytes:
    """One API-0 request of a BT.2100 HLG P010 image (contiguous uint16
    planes) through a new encoder: the encoded stream."""
    h, w = y.shape
    enc = _created(lib.uhdr_create_encoder(), "uhdr_create_encoder")
    try:
        img = RawImage(int(ImgFmt.P010), int(ColorGamut.BT2100),
                       int(ColorTransfer.HLG), int(rng), w, h,
                       (ctypes.c_void_p * 3)(y.ctypes.data, uv.ctypes.data),
                       (ctypes.c_uint * 3)(w, w))
        check(lib.uhdr_enc_set_raw_image(enc, ctypes.byref(img),
                                         int(ImgLabel.HDR)),
              "uhdr_enc_set_raw_image")
        check(lib.uhdr_enc_set_gainmap_scale_factor(enc, scale),
              "uhdr_enc_set_gainmap_scale_factor")
        check(lib.uhdr_enc_set_using_multi_channel_gainmap(
            enc, int(multichannel)),
            "uhdr_enc_set_using_multi_channel_gainmap")
        check(lib.uhdr_enc_set_quality(enc, quality, int(ImgLabel.BASE)),
              "uhdr_enc_set_quality")
        check(lib.uhdr_encode(enc), "uhdr_encode")
        out = lib.uhdr_get_encoded_stream(enc)
        if not out:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "uhdr_get_encoded_stream returned NULL")
        return ctypes.string_at(out.contents.data, out.contents.data_sz)
    finally:
        lib.uhdr_release_encoder(enc)


def decode(lib, data: bytes, fmt: ImgFmt, ct: ColorTransfer) -> np.ndarray:
    """One decode of `data` through a new decoder: the packed output as
    ``UhdrDecoder.decode().planes[0]`` holds it (RGBA1010102 uint32 (h,
    w), RGBAF16 uint16 (h, w, 4))."""
    dec = _created(lib.uhdr_create_decoder(), "uhdr_create_decoder")
    try:
        comp = CompressedImage(
            ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data),
            len(data), int(ColorGamut.UNSPECIFIED),
            int(ColorTransfer.UNSPECIFIED), int(ColorRange.UNSPECIFIED))
        check(lib.uhdr_dec_set_image(dec, ctypes.byref(comp)),
              "uhdr_dec_set_image")
        check(lib.uhdr_dec_set_out_img_format(dec, int(fmt)),
              "uhdr_dec_set_out_img_format")
        check(lib.uhdr_dec_set_out_color_transfer(dec, int(ct)),
              "uhdr_dec_set_out_color_transfer")
        check(lib.uhdr_decode(dec), "uhdr_decode")
        out = lib.uhdr_get_decoded_image(dec)
        if not out:
            raise UhdrError(UhdrErrorCode.UHDR_CODEC_ERROR,
                            "uhdr_get_decoded_image returned NULL")
        img = out.contents
        f16 = ImgFmt(img.fmt) == ImgFmt.RGBAF16
        dtype, shape = (np.uint16, (4,)) if f16 else (np.uint32, ())
        rows = np.frombuffer(
            ctypes.string_at(img.planes[0], img.h * img.stride[0]
                             * np.dtype(dtype).itemsize * (4 if f16 else 1)),
            dtype).reshape((img.h, img.stride[0]) + shape)
        return np.ascontiguousarray(rows[:, :img.w])
    finally:
        lib.uhdr_release_decoder(dec)
