"""ICC v4.3/v4.4 display profile writer + gamut reader.

Byte-exact re-implementation of IccHelper
(lib/src/icc.cpp:158-751, constants icc.h:125-156):
desc/colorant/wtpt/cprt tags always; TRC per transfer (sRGB parametric,
linear parametric, HLG 65-entry tone-mapped table, PQ none); CICP for
HLG/PQ/LINEAR (version bumps to 4.4); PQ additionally gets a 17^3 CLUT
A2B0 (mAB, tone-mapped PQ->Lab) and identity B2A0 (mBA).

The output blob includes the JPEG embedding prefix "ICC_PROFILE\\0" + chunk
count/index bytes, exactly as writeIccProfile returns it.  readIccColorGamut
infers gamut by CICP or colorant-tag matching.

Quirks preserved deliberately: the parametric-curve function-type field is
written via write32(SwapBE16(type)) (icc.cpp:225/232) producing
[type_hi type_lo 00 00]; tag payloads pad to ((len+2)>>2)<<2 bytes.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..types import ColorGamut, ColorTransfer

ICC_IDENTIFIER = b"ICC_PROFILE\x00"  # + chunk count, chunk index
ICC_IDENTIFIER_SIZE = 14
ICC_HEADER_SIZE = 132
TAG_TABLE_ENTRY_SIZE = 12
COLORANT_TAG_SIZE = 20
CICP_TAG_SIZE = 12
TRC_TABLE_SIZE = 65
GRID_SIZE = 17

D50_X, D50_Y, D50_Z = 0.9642, 1.0000, 0.8249


def _tag(s: str) -> int:
    return struct.unpack(">I", s.encode("latin1"))[0]


TAG_desc, TAG_cprt, TAG_wtpt = _tag("desc"), _tag("cprt"), _tag("wtpt")
TAG_rXYZ, TAG_gXYZ, TAG_bXYZ = _tag("rXYZ"), _tag("gXYZ"), _tag("bXYZ")
TAG_rTRC, TAG_gTRC, TAG_bTRC = _tag("rTRC"), _tag("gTRC"), _tag("bTRC")
TAG_cicp, TAG_A2B0, TAG_B2A0 = _tag("cicp"), _tag("A2B0"), _tag("B2A0")
TAG_mluc, TAG_XYZ, TAG_curv = _tag("mluc"), _tag("XYZ "), _tag("curv")
TAG_para, TAG_mAB, TAG_mBA = _tag("para"), _tag("mAB "), _tag("mBA ")

CICP_PRIMARIES = {ColorGamut.BT709: 1, ColorGamut.DISPLAY_P3: 12, ColorGamut.BT2100: 9}
CICP_TRFN = {ColorTransfer.SRGB: 1, ColorTransfer.LINEAR: 8,
             ColorTransfer.PQ: 16, ColorTransfer.HLG: 18}


def _fixed_to_float(x: int) -> float:
    return x * 1.52587890625e-5


def _float_round_to_fixed(x: float) -> int:
    v = int(math.floor(x * 65536.0 + 0.5))
    return max(min(v, 2147483520), -2147483520)


# Colorant matrices (icc.h:125-145; kSRGB from skcms 16.16 fixed point)
K_SRGB_TO_XYZD50 = np.array([
    [_fixed_to_float(0x6FA2), _fixed_to_float(0x6299), _fixed_to_float(0x24A0)],
    [_fixed_to_float(0x38F5), _fixed_to_float(0xB785), _fixed_to_float(0x0F84)],
    [_fixed_to_float(0x0390), _fixed_to_float(0x18DA), _fixed_to_float(0xB6CF)],
], np.float64)
K_P3_TO_XYZD50 = np.array([
    [0.515102, 0.291965, 0.157153],
    [0.241182, 0.692236, 0.0665819],
    [-0.00104941, 0.0418818, 0.784378],
], np.float64)
K_REC2020_TO_XYZD50 = np.array([
    [0.673459, 0.165661, 0.125100],
    [0.279033, 0.675338, 0.0456288],
    [-0.00193139, 0.0299794, 0.797162],
], np.float64)

_GAMUT_MATRICES = {ColorGamut.BT709: K_SRGB_TO_XYZD50,
                   ColorGamut.DISPLAY_P3: K_P3_TO_XYZD50,
                   ColorGamut.BT2100: K_REC2020_TO_XYZD50}


def _pad4(b: bytes) -> bytes:
    total = ((len(b) + 2) >> 2) << 2
    if total > len(b):
        return b + b"\x00" * (total - len(b))
    return b[:total]


def _write_text_tag(text: str) -> bytes:
    tl = len(text)
    header = struct.pack(">IIIIIII", TAG_mluc, 0, 1, 12, _tag("enUS"),
                         2 * tl, 28)
    body = text.encode("ascii").decode("ascii").encode("utf-16-be")
    return _pad4(header + body)


def _write_xyz_tag(x: float, y: float, z: float) -> bytes:
    return struct.pack(">IIiii", TAG_XYZ, 0, _float_round_to_fixed(x),
                       _float_round_to_fixed(y), _float_round_to_fixed(z))


def _write_trc_table(table16: np.ndarray) -> bytes:
    body = struct.pack(">III", TAG_curv, 0, len(table16))
    body += table16.astype(">u2").tobytes()
    return _pad4(body)


def _write_trc_parametric(g, a, b, c, d, e, f) -> bytes:
    if (a, b, c, d, e, f) == (1.0, 0.0, 0.0, 0.0, 0.0, 0.0):
        return struct.pack(">IIHHi", TAG_para, 0, 0, 0, _float_round_to_fixed(g))
    out = struct.pack(">IIHH", TAG_para, 0, 4, 0)
    for v in (g, a, b, c, d, e, f):
        out += struct.pack(">i", _float_round_to_fixed(v))
    return out


SRGB_TRANS_FUN = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045, 0.0, 0.0)
LINEAR_TRANS_FUN = (1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _unorm16(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 65535.0 + 0.5, 0, 65535).astype(np.uint16)


def _compute_tone_map_gain(tf: ColorTransfer, L):
    """compute_tone_map_gain (icc.cpp:242-270), vectorized."""
    L = np.asarray(L, np.float64)
    if tf == ColorTransfer.PQ:
        in_max = 10000 / 203.0
        Ls = L * in_max
        gain = in_max * (1.0 + (1.0 / (in_max * in_max)) * Ls) / (1.0 + Ls)
        return np.where(L <= 0.0, 1.0, gain)
    if tf == ColorTransfer.HLG:
        gamma = 1.2 + 0.42 * math.log(203.0 / 1000.0) / math.log(10.0)
        return np.where(L <= 0.0, 1.0, np.power(np.maximum(L, 1e-37), gamma - 1.0))
    return np.ones_like(L)


def _hlg_oetf_np(e):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    e = np.asarray(e, np.float64)
    return np.where(e <= 1.0 / 12.0, np.sqrt(np.maximum(3.0 * e, 0.0)),
                    a * np.log(np.maximum(12.0 * e - b, 1e-37)) + c)


def _pq_oetf_np(e):
    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1, c2, c3 = 3424.0 / 4096.0, 2413.0 / 4096.0 * 32.0, 2392.0 / 4096.0 * 32.0
    e = np.asarray(e, np.float64)
    ep = np.power(np.maximum(e, 0.0), m1)
    return np.where(e <= 0.0, 0.0,
                    np.power((c1 + c2 * ep) / (1.0 + c3 * ep), m2))


def _write_cicp_tag(primaries: int, trfn: int) -> bytes:
    return struct.pack(">II", TAG_cicp, 0) + bytes([primaries, trfn, 0, 1])


def _write_clut(grid_points, grid16: bytes) -> bytes:
    out = bytearray()
    for i in range(16):
        out.append(grid_points[i] if i < len(grid_points) else 0)
    out += bytes([2, 0, 0, 0])
    out += grid16
    return _pad4(bytes(out))


def _write_mab_or_mba(type_tag: int, has_a_curves: bool,
                      grid_points=None, grid16: bytes | None = None) -> bytes:
    """write_mAB_or_mBA_tag (icc.cpp:341-402).

    NB: the reference returns right after successfully writing the FIRST
    B-curve (the `if (write(...)) return` loop at icc.cpp:389-393 treats
    success as an early-out), leaving the remaining B-curves, CLUT and
    A-curves zero-filled in the allocated tag.  Replicated verbatim for
    byte parity — real libultrahdr PQ profiles ship with a zeroed CLUT."""
    b_curves_offset = 32
    b_curve = _write_trc_parametric(*LINEAR_TRANS_FUN)
    clut = b""
    clut_offset = 0
    a_curves_offset = 0
    total = b_curves_offset + 3 * len(b_curve)
    if has_a_curves:
        clut_offset = b_curves_offset + 3 * len(b_curve)
        clut = _write_clut(grid_points, grid16)
        a_curves_offset = clut_offset + len(clut)
        total += len(clut) + 3 * len(b_curve)
    out = struct.pack(">IIBBHIIIII", type_tag, 0, 3, 3, 0,
                      b_curves_offset, 0, 0, clut_offset, a_curves_offset)
    out += b_curve
    return out + b"\x00" * (total - len(out))


def compute_pq_a2b_grid(src_to_xyzd50: np.ndarray) -> bytes:
    """compute_lut_entry over the 17^3 grid (icc.cpp:283-312), vectorized,
    then XYZ-D50 -> Lab grid16 (icc.cpp:95-117)."""
    n = GRID_SIZE
    rec2020_to_xyzd50 = K_REC2020_TO_XYZD50
    xyzd50_to_rec2020 = np.linalg.inv(rec2020_to_xyzd50)
    src_to_rec2020 = xyzd50_to_rec2020 @ src_to_xyzd50

    r, g, b = np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij")
    rgb = np.stack([r, g, b], axis=-1).reshape(-1, 3).astype(np.float64) / (n - 1.0)
    # "convert source signal to linear" (icc.cpp:291-293 applies pqOetf)
    rgb = _pq_oetf_np(rgb)
    rgb = rgb @ src_to_rec2020.T
    L = rgb @ np.array([0.2627, 0.677998, 0.059302])
    gain = _compute_tone_map_gain(ColorTransfer.PQ, L)
    rgb = rgb * gain[:, None]
    xyz = rgb @ rec2020_to_xyzd50.T

    v = xyz / np.array([D50_X, D50_Y, D50_Z])
    v = np.where(v > 0.008856, np.cbrt(np.maximum(v, 0)), v * 7.787 + 16 / 116.0)
    L_lab = v[:, 1] * 116.0 - 16.0
    a_lab = (v[:, 0] - v[:, 1]) * 500.0
    b_lab = (v[:, 1] - v[:, 2]) * 200.0
    lab = np.stack([L_lab / 100.0, (a_lab + 128.0) / 255.0,
                    (b_lab + 128.0) / 255.0], axis=-1)
    return _unorm16(lab).astype(">u2").tobytes()


def _desc_string(tf: ColorTransfer, gamut: ColorGamut) -> str:
    g = {ColorGamut.BT709: "sRGB", ColorGamut.DISPLAY_P3: "Display P3",
         ColorGamut.BT2100: "Rec2020"}.get(gamut, "Unknown")
    t = {ColorTransfer.SRGB: "sRGB", ColorTransfer.LINEAR: "Linear",
         ColorTransfer.PQ: "PQ", ColorTransfer.HLG: "HLG"}.get(tf, "Unknown")
    return f"{g} Gamut with {t} Transfer"


def write_icc_profile(tf, gamut) -> bytes | None:
    """IccHelper::writeIccProfile (icc.cpp:404-560).  Returns the blob with
    the ICC_PROFILE JPEG-embedding prefix, or None for unspecified gamut."""
    tf = ColorTransfer(tf)
    gamut = ColorGamut(gamut)
    if gamut not in _GAMUT_MATRICES:
        return None
    m = _GAMUT_MATRICES[gamut]
    tags: list[tuple[int, bytes]] = []
    tags.append((TAG_desc, _write_text_tag(_desc_string(tf, gamut))))
    tags.append((TAG_rXYZ, _write_xyz_tag(m[0][0], m[1][0], m[2][0])))
    tags.append((TAG_gXYZ, _write_xyz_tag(m[0][1], m[1][1], m[2][1])))
    tags.append((TAG_bXYZ, _write_xyz_tag(m[0][2], m[1][2], m[2][2])))
    tags.append((TAG_wtpt, _write_xyz_tag(D50_X, D50_Y, D50_Z)))

    if tf != ColorTransfer.PQ:
        if tf == ColorTransfer.HLG:
            x = np.arange(TRC_TABLE_SIZE, dtype=np.float64) / (TRC_TABLE_SIZE - 1.0)
            y = _hlg_oetf_np(x)
            y = y * _compute_tone_map_gain(ColorTransfer.HLG, y)
            table = _unorm16(y)
            trc = _write_trc_table(table)
        elif tf == ColorTransfer.SRGB:
            trc = _write_trc_parametric(*SRGB_TRANS_FUN)
        elif tf == ColorTransfer.LINEAR:
            trc = _write_trc_parametric(*LINEAR_TRANS_FUN)
        else:
            trc = None
        if trc is not None:
            tags.append((TAG_rTRC, trc))
            tags.append((TAG_gTRC, trc))
            tags.append((TAG_bTRC, trc))

    version = 0x04300000
    if tf in (ColorTransfer.HLG, ColorTransfer.PQ, ColorTransfer.LINEAR):
        version = 0x04400000
        tags.append((TAG_cicp, _write_cicp_tag(
            CICP_PRIMARIES.get(gamut, 2), CICP_TRFN.get(tf, 2))))

    if tf == ColorTransfer.PQ:
        grid16 = compute_pq_a2b_grid(m)
        tags.append((TAG_A2B0, _write_mab_or_mba(
            TAG_mAB, True, [GRID_SIZE] * 3, grid16)))
        tags.append((TAG_B2A0, _write_mab_or_mba(TAG_mBA, False)))

    tags.append((TAG_cprt, _write_text_tag("Google Inc. 2022")))

    tag_data_size = sum(len(t[1]) for t in tags)
    tag_table_size = TAG_TABLE_ENTRY_SIZE * len(tags)
    profile_size = ICC_HEADER_SIZE + tag_table_size + tag_data_size

    out = bytearray()
    out += ICC_IDENTIFIER + bytes([1, 1])
    # header (ICCHeader, icc.h:192-233)
    pcs = _tag("Lab ") if tf == ColorTransfer.PQ else _tag("XYZ ")
    out += struct.pack(">I", profile_size)
    out += struct.pack(">I", 0)                     # cmm type
    out += struct.pack(">I", version)
    out += struct.pack(">I", _tag("mntr"))
    out += struct.pack(">I", _tag("RGB "))
    out += struct.pack(">I", pcs)
    out += b"\x00" * 12                             # creation date/time
    out += struct.pack(">I", _tag("acsp"))
    out += struct.pack(">I", 0)                     # platform
    out += struct.pack(">I", 0)                     # flags
    out += struct.pack(">I", 0)                     # manufacturer
    out += struct.pack(">I", 0)                     # model
    out += b"\x00" * 8                              # attributes
    out += struct.pack(">I", 1)                     # rendering intent
    out += struct.pack(">iii", _float_round_to_fixed(D50_X),
                       _float_round_to_fixed(D50_Y), _float_round_to_fixed(D50_Z))
    out += struct.pack(">I", 0)                     # creator
    out += b"\x00" * 16                             # profile id
    out += b"\x00" * 28                             # reserved
    out += struct.pack(">I", len(tags))             # tag count

    offset = ICC_HEADER_SIZE + tag_table_size
    for sig, data in tags:
        out += struct.pack(">III", sig, offset, len(data))
        offset += len(data)
    for _, data in tags:
        out += data
    return bytes(out)


def _tags_equal_matrix(m: np.ndarray, red: bytes, green: bytes, blue: bytes) -> bool:
    tol = 0.001
    for col, tag in enumerate((red, green, blue)):
        vals = struct.unpack_from(">iii", tag, 8)
        for row in range(3):
            if abs(_fixed_to_float(vals[row]) - m[row][col]) > tol:
                return False
    return True


def read_icc_color_gamut(icc: bytes) -> ColorGamut:
    """IccHelper::readIccColorGamut (icc.cpp:640-751)."""
    if icc is None or len(icc) < ICC_HEADER_SIZE + ICC_IDENTIFIER_SIZE:
        return ColorGamut.UNSPECIFIED
    if not icc.startswith(ICC_IDENTIFIER):
        return ColorGamut.UNSPECIFIED
    body = icc[ICC_IDENTIFIER_SIZE:]
    profile_size = len(body)
    tag_count = struct.unpack_from(">I", body, 128)[0]
    max_tags = (profile_size - ICC_HEADER_SIZE) // TAG_TABLE_ENTRY_SIZE
    if tag_count > max_tags:
        return ColorGamut.UNSPECIFIED
    offsets = {}
    for i in range(tag_count):
        sig, off, size = struct.unpack_from(
            ">III", body, ICC_HEADER_SIZE + i * TAG_TABLE_ENTRY_SIZE)
        if sig not in offsets:
            offsets[sig] = (off, size)
    cicp = offsets.get(TAG_cicp)
    if cicp and cicp[1] == CICP_TAG_SIZE and cicp[0] <= profile_size \
            and cicp[1] <= profile_size - cicp[0]:
        primaries = body[cicp[0] + 8]
        for g, p in CICP_PRIMARIES.items():
            if primaries == p:
                return g
    prim = [offsets.get(t) for t in (TAG_rXYZ, TAG_gXYZ, TAG_bXYZ)]
    for p in prim:
        if (p is None or p[1] != COLORANT_TAG_SIZE or p[0] > profile_size
                or p[1] > profile_size - p[0]):
            return ColorGamut.UNSPECIFIED
    r, g, b = (body[p[0]:p[0] + COLORANT_TAG_SIZE] for p in prim)
    for gamut, m in _GAMUT_MATRICES.items():
        if _tags_equal_matrix(m, r, g, b):
            return gamut
    return ColorGamut.UNSPECIFIED
