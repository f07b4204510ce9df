"""Error model mirroring uhdr_error_info_t / uhdr_codec_err_t.

Reference: ultrahdr_api.h:183-209 (error enum + info struct).
The C API returns status structs; in Python we raise UhdrError carrying the
same code so API-level tests can assert on codes like the reference's
invalid-argument matrices (tests/jpegr_test.cpp:387-1363).
"""

from __future__ import annotations

import enum


class UhdrErrorCode(enum.IntEnum):
    """Mirror of uhdr_codec_err_t (ultrahdr_api.h:183-202)."""

    UHDR_CODEC_OK = 0
    UHDR_CODEC_ERROR = 1
    UHDR_CODEC_UNKNOWN_ERROR = 2
    UHDR_CODEC_INVALID_PARAM = 3
    UHDR_CODEC_MEM_ERROR = 4
    UHDR_CODEC_INVALID_OPERATION = 5
    UHDR_CODEC_UNSUPPORTED_FEATURE = 6


class UhdrError(Exception):
    """Python-side carrier of uhdr_error_info_t (code + detail string)."""

    def __init__(self, code: UhdrErrorCode, detail: str = ""):
        self.code = UhdrErrorCode(code)
        self.detail = detail
        super().__init__(f"{self.code.name}: {detail}" if detail else self.code.name)


def invalid_param(detail: str) -> UhdrError:
    return UhdrError(UhdrErrorCode.UHDR_CODEC_INVALID_PARAM, detail)


def invalid_operation(detail: str) -> UhdrError:
    return UhdrError(UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION, detail)


def unsupported(detail: str) -> UhdrError:
    return UhdrError(UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE, detail)
