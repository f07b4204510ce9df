"""Plain baseline JPEG: tables, forward DCT and quantisation, libjpeg's islow
IDCT, a Huffman encoder, a Huffman decoder and a marker parser.

Written from ITU-T T.81 (Annex A DCT, Annex C and F Huffman coding, Annex K
tables) and libjpeg's jidctint.c / jdcolor.c integer arithmetic.  The dense
math is torch on any device and in any float dtype (the control computes
it in bfloat16); the Huffman decoder is numpy.

The decoder runs one lane per restart interval, all intervals of all the
streams it is given side by side, one symbol a lane per step.  A stream
without restart markers is one lane and decodes at a few tens of thousands
of symbols a second.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# T.81 Figure A.6: ZIGZAG[i] is the natural index of the i-th coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
UNZIGZAG = np.argsort(ZIGZAG)

# Annex K.1, natural order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.array([17, 18, 24, 47, 99, 99, 99, 99,
                         18, 21, 26, 66, 99, 99, 99, 99,
                         24, 26, 56, 99, 99, 99, 99, 99,
                         47, 66] + [99] * 38)

# Annex K.3: (code counts for lengths 1..16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of an Annex K table, baseline-clamped."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def canonical_codes(table):
    """Annex C: (code, length) of every symbol, as 256-entry arrays."""
    counts, symbols = table
    code_of = np.zeros(256, np.int64)
    size_of = np.zeros(256, np.int64)
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[i]] = code
            size_of[symbols[i]] = length
            code += 1
            i += 1
        code <<= 1
    return code_of, size_of


# ---------------------------------------------------------------------------
# forward DCT and quantisation

def dct_matrix(dtype, device) -> torch.Tensor:
    """Orthonormal 8-point DCT-II, so D X D^T is the Annex A FDCT."""
    k = torch.arange(8, dtype=torch.float64)
    d = 0.5 * torch.cos((2 * k[None, :] + 1) * k[:, None] * torch.pi / 16)
    d[0, :] = (1.0 / 8.0) ** 0.5
    return d.to(device=device, dtype=dtype)


def pad_edge(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate the last row and column out to (ph, pw)."""
    h, w = plane.shape
    rows = torch.arange(ph, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=plane.device).clamp(max=w - 1)
    return plane.index_select(0, rows).index_select(1, cols)


def fdct_quantise(plane: torch.Tensor, qtable: np.ndarray,
                  dtype=torch.float64) -> torch.Tensor:
    """(H, W) samples 0..255, H and W multiples of 8 -> (H/8, W/8, 64)
    int64 quantised coefficients in zigzag order: level shift, FDCT in
    `dtype`, division by the table, rounding half to even."""
    h, w = plane.shape
    x = plane.to(dtype) - 128.0
    blocks = x.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
    d = dct_matrix(dtype, plane.device)
    coef = d @ blocks @ d.T
    q = torch.as_tensor(qtable.reshape(8, 8), device=plane.device).to(dtype)
    quant = torch.round(coef / q).to(torch.int64).reshape(h // 8, w // 8, 64)
    return quant[..., torch.as_tensor(ZIGZAG, device=plane.device)]


def scan_geometry(h: int, w: int, sampling):
    """(MCUs across, MCUs down) of an image of `sampling` [(h, v), ...]."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    return -(-w // (8 * hmax)), -(-h // (8 * vmax))


def quantised_planes(planes, sampling, qtables, dtype=torch.float64):
    """Each component's (bh, bw, 64) zigzag coefficients, the planes edge-
    padded to whole MCUs first (planes: (h_c, w_c) sample tensors)."""
    h, w = planes[0].shape
    mw, mh = scan_geometry(h, w, sampling)
    return [fdct_quantise(pad_edge(p, mh * vs * 8, mw * hs * 8), q, dtype)
            for p, (hs, vs), q in zip(planes, sampling, qtables)]


# ---------------------------------------------------------------------------
# islow IDCT (libjpeg jidctint.c, CONST_BITS 13, PASS1_BITS 2)

_K = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
          c1175=9633, c1501=12299, c1847=15137, c1961=16069, c2053=16819,
          c2562=20995, c3072=25172)


def _butterfly(s):
    s0, s1, s2, s3, s4, s5, s6, s7 = s
    z1 = (s2 + s6) * _K["c0541"]
    e2 = z1 - s6 * _K["c1847"]
    e3 = z1 + s2 * _K["c0765"]
    e0 = (s0 + s4) * 8192
    e1 = (s0 - s4) * 8192
    t10, t13, t11, t12 = e0 + e3, e0 - e3, e1 + e2, e1 - e2
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _K["c1175"]
    t0 = t0 * _K["c0298"]
    t1 = t1 * _K["c2053"]
    t2 = t2 * _K["c3072"]
    t3 = t3 * _K["c1501"]
    z1 = z1 * -_K["c0899"]
    z2 = z2 * -_K["c2562"]
    z3 = z3 * -_K["c1961"] + z5
    z4 = z4 * -_K["c0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return (t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3)


def idct_islow(zz: torch.Tensor, qtable: np.ndarray, out_h: int,
               out_w: int) -> torch.Tensor:
    """(bh, bw, 64) zigzag coefficients -> (out_h, out_w) int64 samples,
    libjpeg's islow arithmetic and range limit (the coefficients of a
    baseline stream keep every product inside int32, so int64 gives the
    same values)."""
    dev = zz.device
    q = torch.as_tensor(qtable, device=dev).to(torch.int64)
    deq = zz[..., torch.as_tensor(UNZIGZAG, device=dev)].to(torch.int64) * q
    b = deq.reshape(*deq.shape[:-1], 8, 8)
    t = _butterfly([b[..., u, :] for u in range(8)])
    t = torch.stack([(x + 1024) >> 11 for x in t], dim=-2)
    o = _butterfly([t[..., :, v] for v in range(8)])
    s = torch.stack([(x + (1 << 17)) >> 18 for x in o], dim=-1) + 128
    m = s & 1023
    s = torch.where(m < 256, m, torch.where(m < 640, 255, 0))
    bh, bw = s.shape[0], s.shape[1]
    return s.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:out_h, :out_w]


def ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """libjpeg jdcolor.c ycc_rgb_convert on full-resolution int planes:
    (3, h, w) int64 RGB."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.clamp(torch.stack([r, g, b]), 0, 255)


def rgb_to_ycc(rgb: torch.Tensor, dtype=torch.float64):
    """Full-range BT.601 RGB -> YCbCr of a 3-channel gain map before its
    JPEG (jccolor.c's equations, rounded half to even), u8-valued int64."""
    r, g, b = (rgb[i].to(dtype) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return [torch.clamp(torch.round(p), 0, 255).to(torch.int64)
            for p in (y, cb, cr)]


# ---------------------------------------------------------------------------
# MCU order

def scan_block_order(sampling, mcus_w: int, mcus_h: int):
    """(component, block row, block col) of every block in scan order,
    as three int64 arrays (interleaved MCUs; one component: raster)."""
    if len(sampling) == 1:
        bh, bw = mcus_h, mcus_w
        r, c = np.divmod(np.arange(bh * bw), bw)
        return np.zeros(bh * bw, np.int64), r, c
    comp, dy, dx = [], [], []
    for ci, (hs, vs) in enumerate(sampling):
        for v in range(vs):
            for hh in range(hs):
                comp.append(ci)
                dy.append(v)
                dx.append(hh)
    comp, dy, dx = (np.array(a, np.int64) for a in (comp, dy, dx))
    vs_of = np.array([s[1] for s in sampling])[comp]
    hs_of = np.array([s[0] for s in sampling])[comp]
    my, mx = np.divmod(np.arange(mcus_h * mcus_w), mcus_w)
    rows = (my[:, None] * vs_of[None, :] + dy[None, :]).ravel()
    cols = (mx[:, None] * hs_of[None, :] + dx[None, :]).ravel()
    return np.tile(comp, mcus_h * mcus_w), rows, cols


# ---------------------------------------------------------------------------
# Huffman encoder (no restart markers)

def _magnitude(v: torch.Tensor):
    """(size category, extra bits) of signed values (T.81 F.1.2.1)."""
    # the bit length, exactly: frexp's exponent (a log2 may round 2**k
    # down on some devices)
    size = torch.frexp(v.abs().double()).exponent.to(torch.int64)
    extra = torch.where(v >= 0, v, v + (1 << size) - 1)
    return size, extra


def huffman_encode(coefs, sampling, mcus_w: int, mcus_h: int,
                   tables) -> bytes:
    """The entropy-coded segment of one baseline scan, byte-stuffed.
    coefs: per component (bh, bw, 64) int64 zigzag tensors on one device;
    tables: per component ((dc code, dc size), (ac code, ac size))."""
    dev = coefs[0].device
    comp, rows, cols = (torch.as_tensor(a, device=dev)
                        for a in scan_block_order(sampling, mcus_w, mcus_h))
    n = comp.numel()
    blocks = torch.empty((n, 64), dtype=torch.int64, device=dev)
    for ci, c in enumerate(coefs):
        sel = comp == ci
        blocks[sel] = c[rows[sel], cols[sel]]
    # DC differences within each component, in scan order
    dc = blocks[:, 0].clone()
    diff = torch.empty_like(dc)
    for ci in range(len(coefs)):
        idx = torch.nonzero(comp == ci).squeeze(1)
        d = dc[idx]
        diff[idx] = d - torch.cat([d.new_zeros(1), d[:-1]])
    tab = [[torch.as_tensor(np.stack(t), device=dev) for t in pair]
           for pair in tables]                      # [comp][dc/ac] (2, 256)

    def lookup(kind, comps, syms):
        code = torch.zeros_like(syms)
        size = torch.zeros_like(syms)
        for ci in range(len(coefs)):
            sel = comps == ci
            t = tab[ci][kind]
            code[sel] = t[0][syms[sel]]
            size[sel] = t[1][syms[sel]]
        return code, size

    # DC events
    dsz, dext = _magnitude(diff)
    dcode, dlen = lookup(0, comp, dsz)
    keys = [torch.arange(n, device=dev) * 256]
    vals = [(dcode << dsz) | dext]
    lens = [dlen + dsz]
    # AC events: each nonzero with its run, ZRLs before a run of 16 or more
    ac = blocks[:, 1:]
    bi, ki = torch.nonzero(ac, as_tuple=True)
    ki = ki + 1
    first = torch.ones_like(bi, dtype=torch.bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = torch.where(first, torch.zeros_like(ki),
                       torch.cat([ki.new_zeros(1), ki[:-1]]))
    run = ki - prev - 1
    v = ac[bi, ki - 1]
    asz, aext = _magnitude(v)
    sym = ((run % 16) << 4) | asz
    acode, alen = lookup(1, comp[bi], sym)
    keys.append(bi * 256 + ki * 4 + 3)
    vals.append((acode << asz) | aext)
    lens.append(alen + asz)
    for z in range(3):
        zsel = run >= 16 * (z + 1)
        zb = bi[zsel]
        zc, zl = lookup(1, comp[zb], torch.full_like(zb, 0xF0))
        keys.append(zb * 256 + ki[zsel] * 4 + z)
        vals.append(zc)
        lens.append(zl)
    # EOB after the last nonzero unless it is coefficient 63
    last = torch.zeros(n, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, bi, ki, reduce="amax")
    eb = torch.nonzero(last < 63).squeeze(1)
    ec, el = lookup(1, comp[eb], torch.zeros_like(eb))
    keys.append(eb * 256 + 255)
    vals.append(ec)
    lens.append(el)
    keys, vals, lens = (torch.cat(x) for x in (keys, vals, lens))
    order = torch.argsort(keys)
    vals, lens = vals[order], lens[order]
    # bits, most significant first, then 1-bits to the byte boundary
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1])
    ev = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                 lens)
    j = torch.arange(total, device=dev) - (ends - lens)[ev]
    bits = (vals[ev] >> (lens[ev] - 1 - j)) & 1
    pad = (-total) % 8
    bits = torch.cat([bits, torch.ones(pad, dtype=torch.int64, device=dev)])
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    data = (bits.reshape(-1, 8) * weights).sum(1).to(torch.uint8)
    data = data.cpu().numpy()
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


# ---------------------------------------------------------------------------
# markers

def segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def write_jpeg(h: int, w: int, sampling, qtables, coefs,
               app_segments=()) -> bytes:
    """A baseline JPEG: SOI, the given APPn segments, DQT, SOF0, DHT (the
    Annex K tables), SOS, the scan, EOI.  Component 0 uses the luma tables,
    the others the chroma ones; no DRI."""
    nq = 1 if len(sampling) == 1 else 2
    out = bytearray(b"\xFF\xD8")
    for seg in app_segments:
        out += seg
    for t in range(nq):
        out += segment(0xDB, bytes([t]) + bytes(
            qtables[t][ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, h, w, len(sampling))
    for ci, (hs, vs) in enumerate(sampling):
        sof += bytes([ci + 1, hs << 4 | vs, min(ci, 1)])
    out += segment(0xC0, sof)
    for t, (dc, ac) in enumerate([(DC_LUMA, AC_LUMA),
                                  (DC_CHROMA, AC_CHROMA)][:nq]):
        out += segment(0xC4, bytes([t]) + bytes(dc[0]) + bytes(dc[1]))
        out += segment(0xC4, bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1]))
    sos = bytes([len(sampling)])
    for ci in range(len(sampling)):
        t = min(ci, 1)
        sos += bytes([ci + 1, t << 4 | t])
    out += segment(0xDA, sos + bytes([0, 63, 0]))
    mw, mh = scan_geometry(h, w, sampling)
    tables = [tuple(canonical_codes(t) for t in (
        (DC_LUMA, AC_LUMA) if ci == 0 else (DC_CHROMA, AC_CHROMA)))
        for ci in range(len(sampling))]
    out += huffman_encode(coefs, sampling, mw, mh, tables)
    out += b"\xFF\xD9"
    return bytes(out)


class Parsed:
    """The headers of one JPEG and its entropy-coded data."""

    def __init__(self):
        self.app = []            # (marker, payload)
        self.qt = {}
        self.huff = {}           # (class, id) -> (counts, symbols)
        self.h = self.w = 0
        self.comps = []          # (id, hs, vs, tq)
        self.scan_tables = []    # (td, ta) per component in scan order
        self.dri = 0
        self.sof = None
        self.data = b""


def parse_jpeg(buf: bytes) -> Parsed:
    """Headers up to the first SOS and the scan data up to EOI; raises
    ValueError on anything but a baseline single-scan JPEG."""
    p = Parsed()
    if buf[:2] != b"\xFF\xD8":
        raise ValueError("no SOI")
    pos = 2
    while True:
        if buf[pos] != 0xFF:
            raise ValueError(f"marker expected at {pos}")
        m = buf[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        ln = struct.unpack_from(">H", buf, pos + 2)[0]
        body = buf[pos + 4:pos + 2 + ln]
        if 0xE0 <= m <= 0xEF:
            p.app.append((m, bytes(body)))
        elif m == 0xDB:
            i = 0
            while i < len(body):
                if body[i] >> 4:
                    raise ValueError("16-bit quantisation table")
                t = np.zeros(64, np.int64)
                t[ZIGZAG] = np.frombuffer(body[i + 1:i + 65], np.uint8)
                p.qt[body[i] & 15] = t
                i += 65
        elif m == 0xC4:
            i = 0
            while i < len(body):
                counts = list(body[i + 1:i + 17])
                k = sum(counts)
                p.huff[(body[i] >> 4, body[i] & 15)] = (
                    counts, list(body[i + 17:i + 17 + k]))
                i += 17 + k
        elif m == 0xDD:
            p.dri = struct.unpack(">H", body[:2])[0]
        elif m in (0xC0, 0xC1):
            p.sof = m
            _, p.h, p.w, n = struct.unpack_from(">BHHB", body)
            p.comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                        body[7 + 3 * i] & 15, body[8 + 3 * i])
                       for i in range(n)]
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"not baseline (SOF{m - 0xC0})")
        elif m == 0xDA:
            n = body[0]
            ids = [c[0] for c in p.comps]
            if n != len(p.comps) or [body[1 + 2 * i] for i in range(n)] \
                    != ids:
                raise ValueError("scan does not hold every component")
            p.scan_tables = [(body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                             for i in range(n)]
            start = pos + 2 + ln
            end = buf.find(b"\xFF\xD9", start)
            while end >= 0 and buf[end - 1] == 0xFF and _stuffed(buf, end):
                end = buf.find(b"\xFF\xD9", end + 1)
            if end < 0:
                raise ValueError("no EOI")
            p.data = bytes(buf[start:end])
            return p
        pos += 2 + ln


def _stuffed(buf, end) -> bool:
    """Whether the 0xFF before `end` is itself data (an odd run of 0xFF)."""
    k = end - 1
    while k >= 0 and buf[k] == 0xFF:
        k -= 1
    return (end - 1 - k) % 2 == 0


def split_intervals(data: bytes):
    """The restart intervals of a scan's data, unstuffed."""
    out, cur, i, n = [], bytearray(), 0, len(data)
    while i < n:
        j = data.find(b"\xFF", i)
        if j < 0:
            cur += data[i:]
            break
        cur += data[i:j]
        nxt = data[j + 1] if j + 1 < n else 0
        if nxt == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            i = j + 2
        elif nxt == 0xFF:
            i = j + 1
        else:
            raise ValueError(f"marker 0xFF{nxt:02X} inside the scan")
    out.append(bytes(cur))
    return out


def _lookup_table(table):
    """65536-entry (length, symbol) of a 16-bit window; length 0 marks a
    window that starts with no valid code."""
    counts, symbols = table
    ln = np.zeros(65536, np.int64)
    sym = np.zeros(65536, np.int64)
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            ln[lo:hi] = length
            sym[lo:hi] = symbols[i]
            code += 1
            i += 1
        code <<= 1
    return ln, sym


def huffman_decode(streams):
    """Decode the scans of several parsed JPEGs at once.

    Returns, per stream, its components' (bh, bw, 64) int64 zigzag
    coefficient arrays, or the string of the error that stopped it (an
    invalid code, a block past coefficient 63, data that ends early, a
    wrong number of restart intervals)."""
    lanes = []            # (stream, first block, n blocks, bytes)
    meta = []
    tables, tindex = [], {}
    for si, p in enumerate(streams):
        sampling = [(c[1], c[2]) for c in p.comps]
        mw, mh = scan_geometry(p.h, p.w, sampling)
        comp, rows, cols = scan_block_order(sampling, mw, mh)
        per_mcu = len(comp) // (mw * mh)
        n_mcu = mw * mh
        every = p.dri or n_mcu
        ivals = split_intervals(p.data)
        n_iv = -(-n_mcu // every)
        err = None
        if len(ivals) != n_iv:
            err = f"{len(ivals)} restart intervals, expected {n_iv}"
        tids = []
        for (td, ta) in p.scan_tables:
            pair = []
            for key in ((0, td), (1, ta)):
                if key not in p.huff:
                    err = f"missing Huffman table {key}"
                    pair.append(0)
                    continue
                k = (tuple(p.huff[key][0]), tuple(p.huff[key][1]))
                if k not in tindex:
                    tindex[k] = len(tables)
                    tables.append(_lookup_table(p.huff[key]))
                pair.append(tindex[k])
            tids.append(pair)
        meta.append(dict(sampling=sampling, comp=comp, rows=rows, cols=cols,
                         n=len(comp), per_mcu=per_mcu, err=err, tids=tids))
        if err is None:
            for i, iv in enumerate(ivals):
                nb = min(every, n_mcu - i * every) * per_mcu
                lanes.append((si, i * every * per_mcu, nb, iv))
    results = [None] * len(streams)
    for si, m in enumerate(meta):
        if m["err"] is not None:
            results[si] = m["err"]
    if lanes:
        _decode_lanes(lanes, meta, tables, results)
    out = []
    for si, (p, m) in enumerate(zip(streams, meta)):
        if isinstance(results[si], str):
            out.append(results[si])
            continue
        blocks = results[si]
        planes = []
        for ci, (hs, vs) in enumerate(m["sampling"]):
            sel = m["comp"] == ci
            bh, bw = m["rows"][sel].max() + 1, m["cols"][sel].max() + 1
            plane = np.zeros((bh, bw, 64), np.int64)
            plane[m["rows"][sel], m["cols"][sel]] = blocks[sel]
            planes.append(plane)
        out.append(planes)
    return out


def _decode_lanes(lanes, meta, tables, results):
    """One symbol of every unfinished lane per step; finished lanes are
    dropped from the step's arrays every 512 steps."""
    nl = len(lanes)
    t_len = np.stack([t[0] for t in tables]).ravel()
    t_sym = np.stack([t[1] for t in tables]).ravel()
    buf = bytearray()
    base = np.zeros(nl, np.int64)
    end = np.zeros(nl, np.int64)
    for i, (_, _, _, data) in enumerate(lanes):
        base[i] = len(buf) * 8
        buf += data
        end[i] = len(buf) * 8
    raw = np.frombuffer(bytes(buf) + bytes(16), np.uint8).astype(np.uint64)
    # W[i]: the 8 bytes from i on, big endian, so one gather reads a window
    W = np.zeros(len(raw) - 8, np.uint64)
    for j in range(8):
        W |= raw[j:j + len(W)] << np.uint64(56 - 8 * j)
    stream = np.array([ln[0] for ln in lanes])
    first = np.array([ln[1] for ln in lanes])
    nblk = np.array([ln[2] for ln in lanes])
    # each lane's MCU pattern: the component, and the 65536-entry offsets of
    # its DC and AC tables, of the j-th block of an MCU
    plen = np.zeros(nl, np.int64)
    pcomp = np.zeros((nl, 10), np.int64)
    pdc = np.zeros((nl, 10), np.int64)
    pac = np.zeros((nl, 10), np.int64)
    for i, si in enumerate(stream):
        m = meta[si]
        per = m["per_mcu"]
        plen[i] = per
        comps = m["comp"][:per]
        pcomp[i, :per] = comps
        pdc[i, :per] = [m["tids"][c][0] * 65536 for c in comps]
        pac[i, :per] = [m["tids"][c][1] * 65536 for c in comps]
    offs = np.zeros(len(meta) + 1, np.int64)
    for si, m in enumerate(meta):
        offs[si + 1] = offs[si] + (m["n"] if m["err"] is None else 0)
    coef = np.zeros((offs[-1], 64), np.int64)
    bad = np.zeros(nl, bool)
    # the step's lanes and their state
    ix = np.nonzero(nblk > 0)[0]
    pos = base[ix].copy()
    blk = np.zeros(len(ix), np.int64)
    k = np.zeros(len(ix), np.int64)
    pred = np.zeros((len(ix), 3), np.int64)
    gb = offs[stream[ix]] + first[ix]
    nb, lim = nblk[ix], end[ix]
    pl, pc, pd, pa = plen[ix], pcomp[ix], pdc[ix], pac[ix]
    live = np.ones(len(ix), bool)
    ar = np.arange(len(ix))
    step = 0
    u = np.uint64
    while live.any():
        step += 1
        if step % 512 == 0:
            keep = np.nonzero(live)[0]
            ix, pos, blk, k, pred = ix[keep], pos[keep], blk[keep], \
                k[keep], pred[keep]
            gb, nb, lim, pl, pc, pd, pa = (x[keep] for x in (
                gb, nb, lim, pl, pc, pd, pa))
            live = live[keep]
            ar = np.arange(len(ix))
        j = blk % pl
        comp = pc[ar, j]
        is_dc = k == 0
        tab = np.where(is_dc, pd[ar, j], pa[ar, j])
        win = W[pos >> 3] << (pos & 7).astype(u)
        top = (win >> u(48)).astype(np.int64)
        ln = t_len[tab + top]
        sym = t_sym[tab + top]
        size = np.where(is_dc, sym, sym & 15)
        sz = np.maximum(size, 1).astype(u)
        extra = ((win << ln.astype(u)) >> (u(64) - sz)).astype(np.int64)
        extra = np.where(size > 0, extra, 0)
        val = np.where(extra < (1 << (size - 1).clip(0)),
                       extra - (1 << size) + 1, extra)
        val = np.where(size > 0, val, 0)
        g = gb + blk
        # DC: the predictor of the block's component
        d = np.nonzero(is_dc & live)[0]
        pv = pred[d, comp[d]] + val[d]
        pred[d, comp[d]] = pv
        coef[g[d], 0] = pv
        # AC: EOB, ZRL or a run and a value
        run = sym >> 4
        eob = ~is_dc & (sym == 0)
        zrl = ~is_dc & (sym == 0xF0)
        kpos = k + run
        lit = ~is_dc & ~eob & ~zrl
        over = (lit & (kpos > 63)) | (zrl & (k + 16 > 63))
        a = np.nonzero(lit & ~over & live)[0]
        coef[g[a], kpos[a]] = val[a]
        knew = np.where(is_dc, 1, np.where(eob, 64, np.where(
            zrl, k + 16, kpos + 1)))
        newpos = pos + ln + size
        err = live & ((ln == 0) | over | (newpos > lim))
        done = knew >= 64
        blk = np.where(live, blk + done, blk)
        k = np.where(live & ~done, knew, 0)
        pos = np.where(live, newpos, pos)
        if err.any():
            bad[ix[err]] = True
        live = live & ~err & (blk < nb)
    for si in range(len(meta)):
        if results[si] is not None:
            continue
        if bad[stream == si].any():
            results[si] = "invalid Huffman data"
        else:
            results[si] = coef[offs[si]:offs[si + 1]]
