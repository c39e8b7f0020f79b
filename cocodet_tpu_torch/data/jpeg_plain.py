"""The plain versions of the JPEG codec of ``csrc/host/jpeg.cpp``, stage by
stage in Python and numpy, written from the JPEG standard (ITU T.81) and
the libjpeg sources they follow; the tests and ``chip_smoke.py`` hold the
C++ against them.

Decoder: ``parse`` (markers, tables, the frame, the scans' entropy-coded
segments), ``decode_scan`` (Huffman, a bit at a time), ``idct_islow``
(dequantise and jidctint.c's integer IDCT over whole arrays of blocks),
``upsample`` (jdsample.c's triangle filters, with whole-array edge
replication where the C++ walks rows), ``ycc_to_bgr`` (jdcolor.c's tables)
and ``decode``. Encoder: ``bgr_to_ycc``, ``downsample_h2v2``,
``fdct_quantize`` (jfdctint.c, then a rounding division where libjpeg-turbo
multiplies by a reciprocal; the two agree on every value an 8-bit DCT can
give), ``huffman_encode`` and ``encode``. The Huffman loops take about a
second for a 256 x 256 image: these are for small images.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K: the example quantisation tables (natural order) and Huffman tables
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
    104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99,
    99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374757677"
    "78797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# jidctint.c / jfdctint.c constants (CONST_BITS 13)
FIX = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
           c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)


class UnsupportedJPEG(NotImplementedError):
    pass


class CorruptJPEG(ValueError):
    pass


# ------------------------------------------------------------------ parse
def huffman_codes(bits, vals) -> Dict[Tuple[int, int], int]:
    """{(length, code): symbol} of a table given as its 16 counts and its
    symbols (T.81 Annex C)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[(length, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return codes


def _exif_orientation(body: bytes) -> int:
    """OpenCV's reading: skip 6 bytes, a TIFF header, IFD0, tag 0x0112."""
    d = body[6:]
    if d[:2] not in (b"II", b"MM"):
        return 0
    e = "<" if d[:2] == b"II" else ">"
    try:
        if struct.unpack_from(e + "H", d, 2)[0] != 0x2A:
            return 0
        off = struct.unpack_from(e + "I", d, 4)[0]
        count = struct.unpack_from(e + "H", d, off)[0]
        found = 0
        for i in range(count):
            p = off + 2 + 12 * i
            if struct.unpack_from(e + "H", d, p)[0] == 0x0112:
                found = struct.unpack_from(e + "H", d, p + 8)[0]
        return found
    except struct.error:
        return 0


def parse(data: bytes) -> dict:
    """The file's frame, tables and scans. Each scan is (header fields,
    tables in force, entropy-coded bytes up to the next marker that is not
    RSTn)."""
    if data[:2] != b"\xff\xd8":
        raise CorruptJPEG("not a JPEG file")
    info = dict(frame=None, scans=[], restart=0, jfif=False, adobe=None, orientation=0)
    qt: Dict[int, np.ndarray] = {}
    ht: Dict[Tuple[int, int], dict] = {}
    app1 = False
    p = 2
    while True:
        while p < len(data) and data[p] != 0xFF:
            p += 1
        while p < len(data) and data[p] == 0xFF:
            p += 1
        if p >= len(data):
            raise CorruptJPEG("truncated JPEG file")
        marker = data[p]
        p += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7:
            continue
        if p + 2 > len(data):
            raise CorruptJPEG("truncated JPEG file")
        length = struct.unpack_from(">H", data, p)[0]
        body = data[p + 2:p + length]
        if length < 2 or len(body) != length - 2:
            raise CorruptJPEG("truncated JPEG marker segment")
        p += length
        if marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack_from(">BHHB", body)
            if prec != 8:
                raise UnsupportedJPEG("12-bit JPEG" if prec == 12 else "JPEG precision")
            if nc == 4:
                raise UnsupportedJPEG("4-component (CMYK/YCCK) JPEG")
            comps = [dict(id=body[6 + 3 * c], h=body[7 + 3 * c] >> 4, v=body[7 + 3 * c] & 15,
                          tq=body[8 + 3 * c]) for c in range(nc)]
            info["frame"] = dict(height=h, width=w, comps=comps)
        elif marker in (0xC2, 0xC6, 0xCA, 0xCE):
            raise UnsupportedJPEG("progressive JPEG")
        elif marker in (0xC3, 0xC7, 0xCB, 0xCF):
            raise UnsupportedJPEG("lossless JPEG")
        elif marker in (0xC9, 0xCC, 0xCD):
            raise UnsupportedJPEG("arithmetic-coded JPEG")
        elif marker == 0xC4:
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                bits = list(body[q + 1:q + 17])
                vals = list(body[q + 17:q + 17 + sum(bits)])
                ht[(tc, th)] = huffman_codes(bits, vals)
                q += 17 + sum(bits)
        elif marker == 0xDB:
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                n = 64 * (pq + 1)
                raw = np.frombuffer(body[q + 1:q + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw
                qt[tq] = table
                q += 1 + n
        elif marker == 0xDD:
            info["restart"] = struct.unpack_from(">H", body)[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            info["jfif"] = True
        elif marker == 0xE1 and not app1:
            app1 = True
            info["orientation"] = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            info["adobe"] = body[11]
        elif marker == 0xDA:
            ns = body[0]
            comps = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                     for i in range(ns)]
            end = p
            while end + 1 < len(data) and not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
                                               and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            info["scans"].append(dict(comps=comps, qt=dict(qt), ht=dict(ht),
                                      restart=info["restart"], data=data[p:end]))
            p = end
    if info["frame"] is None or not info["scans"]:
        raise CorruptJPEG("JPEG file without a frame or a scan")
    return info


# ---------------------------------------------------------------- Huffman
def _segments(entropy: bytes) -> List[np.ndarray]:
    """The bits of each restart interval, stuffing removed."""
    out, cur, i = [], bytearray(), 0
    while i < len(entropy):
        b = entropy[i]
        if b == 0xFF and i + 1 < len(entropy):
            nxt = entropy[i + 1]
            if nxt == 0:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:
                out.append(cur)
                cur = bytearray()
                i += 2
                continue
        cur.append(b)
        i += 1
    out.append(cur)
    return [np.unpackbits(np.frombuffer(bytes(s), np.uint8)) for s in out]


def decode_scan(scan: dict, frame: dict, coefs: Dict[int, np.ndarray]) -> None:
    """Huffman-decodes a sequential scan into ``coefs[component index]``,
    (block rows, block columns, 64) arrays in natural order."""
    comps = frame["comps"]
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    ids = [c["id"] for c in comps]
    members = [(ids.index(cid), td, ta) for cid, td, ta in scan["comps"]]
    if len(members) == 1:
        ci = members[0][0]
        c = comps[ci]
        cw = -(-frame["width"] * c["h"] // max_h)
        ch = -(-frame["height"] * c["v"] // max_v)
        mcux, mcuy, shape = -(-cw // 8), -(-ch // 8), {ci: (1, 1)}
    else:
        mcux = -(-frame["width"] // (8 * max_h))
        mcuy = -(-frame["height"] // (8 * max_v))
        shape = {ci: (comps[ci]["v"], comps[ci]["h"]) for ci, _, _ in members}
    segs = _segments(scan["data"])
    restart = scan["restart"] or mcux * mcuy
    seg_i, pos, bits = 0, 0, segs[0]
    pred = {}

    def read(n):
        nonlocal pos
        if pos + n > len(bits):
            raise CorruptJPEG("truncated or corrupt JPEG entropy-coded data")
        v = 0
        for b in bits[pos:pos + n]:
            v = (v << 1) | int(b)
        pos += n
        return v

    def symbol(codes):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | read(1)
            if (length, code) in codes:
                return codes[(length, code)]
        raise CorruptJPEG("bad Huffman code in JPEG data")

    def extend(v, s):
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v

    for m in range(mcux * mcuy):
        if m and m % restart == 0:
            seg_i += 1
            if seg_i >= len(segs):
                raise CorruptJPEG("JPEG restart marker missing")
            bits, pos, pred = segs[seg_i], 0, {}
        my, mx = divmod(m, mcux)
        for ci, td, ta in members:
            bv, bh = shape[ci]
            dc_codes, ac_codes = scan["ht"][(0, td)], scan["ht"][(1, ta)]
            for by in range(bv):
                for bx in range(bh):
                    blk = coefs[ci][my * bv + by, mx * bh + bx]
                    s = symbol(dc_codes)
                    pred[ci] = pred.get(ci, 0) + extend(read(s), s)
                    blk[0] = pred[ci]
                    k = 1
                    while k < 64:
                        rs = symbol(ac_codes)
                        r, s = rs >> 4, rs & 15
                        if s == 0:
                            if r != 15:
                                break
                            k += 16
                            continue
                        k += r
                        if k > 63:
                            raise CorruptJPEG("JPEG block runs past coefficient 63")
                        blk[ZIGZAG[k]] = extend(read(s), s)
                        k += 1


# ------------------------------------------------------------------- IDCT
def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """One jidctint.c pass over arrays (the even part, then the odd part);
    returns the eight outputs before descaling."""
    z1 = (x2 + x6) * FIX["c0541"]
    t2 = z1 - x6 * FIX["c1847"]
    t3 = z1 + x2 * FIX["c0765"]
    t0 = (x0 + x4) << 13
    t1 = (x0 - x4) << 13
    e10, e13, e11, e12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    a0, a1, a2, a3 = x7, x5, x3, x1
    z1, z2, z3, z4 = a0 + a3, a1 + a2, a0 + a2, a1 + a3
    z5 = (z3 + z4) * FIX["c1175"]
    a0, a1, a2, a3 = a0 * FIX["c0298"], a1 * FIX["c2053"], a2 * FIX["c3072"], a3 * FIX["c1501"]
    z1, z2 = z1 * -FIX["c0899"], z2 * -FIX["c2562"]
    z3, z4 = z3 * -FIX["c1961"] + z5, z4 * -FIX["c0390"] + z5
    a0, a1, a2, a3 = a0 + z1 + z3, a1 + z2 + z4, a2 + z2 + z3, a3 + z1 + z4
    return (e10 + a3, e11 + a2, e12 + a1, e13 + a0, e13 - a0, e12 - a1, e11 - a2, e10 - a3)


def idct_range_limit(v: np.ndarray) -> np.ndarray:
    """jdmaster.c's sample_range_limit table as the IDCT indexes it: the
    value (128 too low) masked to 10 bits, then clamped or wrapped."""
    x = v & 1023
    return np.where(x < 128, x + 128, np.where(x < 512, 255, np.where(x < 896, 0, x - 896)))


def idct_islow(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order coefficients and a quantisation table ->
    (..., 8, 8) uint8 samples."""
    c = (blocks.astype(np.int64) * q.astype(np.int64)).reshape(blocks.shape[:-1] + (8, 8))
    cols = _idct_1d(*[c[..., r, :] for r in range(8)])  # over each column
    ws = np.stack([_descale(v, 11) for v in cols], axis=-2)
    rows = _idct_1d(*[ws[..., :, k] for k in range(8)])  # over each row
    out = np.stack([_descale(v, 18) for v in rows], axis=-1)
    return idct_range_limit(out).astype(np.uint8)


# -------------------------------------------------------------- upsample
def upsample(plane: np.ndarray, dw: int, dh: int, hx: int, vx: int, width: int,
             height: int) -> np.ndarray:
    """A component's (dh, dw) samples to (height, width) as jdsample.c does
    under do_fancy_upsampling."""
    s = plane[:dh, :dw].astype(np.int64)
    if hx == 1 and vx == 1:
        return s[:height, :width].astype(np.uint8)
    if vx == 2 and (hx == 1 or (hx == 2 and dw > 2)):
        up = np.concatenate([s[:1], s[:-1]])     # the row above, row 0 repeated
        down = np.concatenate([s[1:], s[-1:]])   # the row below, the last repeated
        if hx == 1:
            rows = np.empty((2 * dh, dw), np.int64)
            rows[0::2] = (3 * s + up + 1) >> 2
            rows[1::2] = (3 * s + down + 2) >> 2
            return rows[:height, :width].astype(np.uint8)
        sums = np.empty((2 * dh, dw), np.int64)
        sums[0::2] = 3 * s + up
        sums[1::2] = 3 * s + down
        left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
        out = np.empty((2 * dh, 2 * dw), np.int64)
        out[:, 0::2] = (3 * sums + left + 8) >> 4
        out[:, 1::2] = (3 * sums + right + 7) >> 4
        return out[:height, :width].astype(np.uint8)
    if hx == 2 and vx == 1 and dw > 2:
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int64)
        out[:, 0::2] = (3 * s + left + 1) >> 2
        out[:, 1::2] = (3 * s + right + 2) >> 2
        return out[:height, :width].astype(np.uint8)
    return np.repeat(np.repeat(s, vx, 0), hx, 1)[:height, :width].astype(np.uint8)


# ----------------------------------------------------------------- colour
def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert, as BGR."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    xb, xr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * xr + (1 << 15)) >> 16)
    b = y + ((_fix(1.77200) * xb + (1 << 15)) >> 16)
    g = y + ((-_fix(0.34414) * xb + (1 << 15) - _fix(0.71414) * xr) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> Tuple[np.ndarray, int]:
    """((H, W, 3) uint8 BGR, EXIF orientation) of a JPEG file's bytes."""
    info = parse(data)
    frame = info["frame"]
    comps = frame["comps"]
    W, H = frame["width"], frame["height"]
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    mcux, mcuy = -(-W // (8 * max_h)), -(-H // (8 * max_v))
    coefs = {i: np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64)
             for i, c in enumerate(comps)}
    tables: Dict[int, np.ndarray] = {}
    for scan in info["scans"]:
        for cid, _, _ in scan["comps"]:
            ci = [c["id"] for c in comps].index(cid)
            tables.setdefault(ci, scan["qt"][comps[ci]["tq"]])  # latched at the first scan
        decode_scan(scan, frame, coefs)
    if len(tables) != len(comps):
        raise CorruptJPEG("JPEG component missing from every scan")
    planes = []
    for i, c in enumerate(comps):
        dw, dh = -(-W * c["h"] // max_h), -(-H * c["v"] // max_v)
        blocks = idct_islow(coefs[i], tables[i])  # (rows, cols, 8, 8)
        samp = blocks.transpose(0, 2, 1, 3).reshape(blocks.shape[0] * 8, blocks.shape[1] * 8)
        planes.append(upsample(samp, dw, dh, max_h // c["h"], max_v // c["v"], W, H))
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2), info["orientation"]
    ids = [c["id"] for c in comps]
    rgb = not info["jfif"] and (info["adobe"] == 0 if info["adobe"] is not None
                                else ids == [82, 71, 66])
    if rgb:
        return np.stack(planes[::-1], -1), info["orientation"]
    return ycc_to_bgr(*planes), info["orientation"]


# ---------------------------------------------------------------- encoder
def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (baseline)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def bgr_to_ycc(img: np.ndarray) -> np.ndarray:
    """jccolor.c's rgb_ycc_convert of a BGR image -> (3, H, W) YCbCr."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + half - 1) >> 16
    return np.stack([y, cb, cr])


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge replication to (h, w) (jcprepro.c / jcsample.c's expand_*)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample: 2x2 sums with bias 1, 2, 1, 2, ... along
    each output row."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _fdct_1d(x0, x1, x2, x3, x4, x5, x6, x7, first: bool):
    t0, t7, t1, t6 = x0 + x7, x0 - x7, x1 + x6, x1 - x6
    t2, t5, t3, t4 = x2 + x5, x2 - x5, x3 + x4, x3 - x4
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = 11 if first else 15
    o0 = (t10 + t11) << 2 if first else _descale(t10 + t11, 2)
    o4 = (t10 - t11) << 2 if first else _descale(t10 - t11, 2)
    z1 = (t12 + t13) * FIX["c0541"]
    o2 = _descale(z1 + t13 * FIX["c0765"], sh)
    o6 = _descale(z1 - t12 * FIX["c1847"], sh)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * FIX["c1175"]
    z1, z2 = z1 * -FIX["c0899"], z2 * -FIX["c2562"]
    z3, z4 = z3 * -FIX["c1961"] + z5, z4 * -FIX["c0390"] + z5
    o7 = _descale(t4 * FIX["c0298"] + z1 + z3, sh)
    o5 = _descale(t5 * FIX["c2053"] + z2 + z4, sh)
    o3 = _descale(t6 * FIX["c3072"] + z2 + z3, sh)
    o1 = _descale(t7 * FIX["c1501"] + z1 + z4, sh)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(8 rows, 8 cols) blocks of a padded plane -> (rows, cols, 64)
    quantised coefficients in natural order."""
    h, w = plane.shape
    blk = (plane.astype(np.int64) - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    rows = _fdct_1d(*[blk[..., k] for k in range(8)], first=True)
    ws = np.stack(rows, axis=-1)
    cols = _fdct_1d(*[ws[..., r, :] for r in range(8)], first=False)
    d = np.stack(cols, axis=-2).reshape(h // 8, w // 8, 64)
    div = (q.astype(np.int64) << 3)
    mag = (np.abs(d) + div // 2) // div
    return np.where(d < 0, -mag, mag)


def huffman_encode(blocks: List[Tuple[np.ndarray, int, tuple, tuple]]) -> bytes:
    """Entropy-codes (block, component, DC table, AC table) in order: DC
    differences, AC run lengths with ZRL and EOB, 0xFF stuffing, 1-padding."""
    enc = {}
    bits_out: List[str] = []
    pred: Dict[int, int] = {}
    for blk, comp, dct, act in blocks:
        for table in (dct, act):
            if id(table) not in enc:
                enc[id(table)] = {v: format(code, f"0{ln}b")
                                  for (ln, code), v in huffman_codes(*table).items()}
        dc_codes, ac_codes = enc[id(dct)], enc[id(act)]
        zz = [int(v) for v in blk[ZIGZAG]]
        diff = zz[0] - pred.get(comp, 0)
        pred[comp] = zz[0]
        nb = abs(diff).bit_length()
        bits_out.append(dc_codes[nb])
        if nb:
            bits_out.append(format(diff if diff > 0 else diff - 1 + (1 << nb), f"0{nb}b"))
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits_out.append(ac_codes[0xF0])
                run -= 16
            nb = abs(v).bit_length()
            bits_out.append(ac_codes[(run << 4) | nb])
            bits_out.append(format(v if v > 0 else v - 1 + (1 << nb), f"0{nb}b"))
            run = 0
        if run:
            bits_out.append(ac_codes[0])
    s = "".join(bits_out)
    s += "1" * (-len(s) % 8)
    out = bytearray()
    for i in range(0, len(s), 8):
        out.append(int(s[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def encode(img: np.ndarray) -> bytes:
    """The file cv2.imwrite writes for an (H, W, 3) BGR or (H, W) grey image
    with no parameters (quality 95)."""
    h, w = img.shape[:2]
    grey = img.ndim == 2
    qs = [quant_table(STD_LUMA_Q, 95), quant_table(STD_CHROMA_Q, 95)]
    s = 1 if grey else 2
    mh, mw = -(-h // (8 * s)) * 8 * s, -(-w // (8 * s)) * 8 * s
    if grey:
        planes = [_pad(img.astype(np.int64), mh, mw)]
    else:
        y, cb, cr = (_pad(p, mh, mw) for p in bgr_to_ycc(img))
        ch = -(-h // 2)  # chroma rows from the image; the rest repeat the last
        planes = [y] + [_pad(downsample_h2v2(p)[:ch], mh // 2, mw // 2) for p in (cb, cr)]
    coefs = [fdct_quantize(p, qs[min(i, 1)]) for i, p in enumerate(planes)]
    blocks = []
    if grey:
        for by in range(-(-h // 8)):
            for bx in range(-(-w // 8)):
                blocks.append((coefs[0][by, bx], 0, DC_LUMA, AC_LUMA))
    else:
        ybh, ybw = -(-h // 8), -(-w // 8)
        for my in range(mh // 16):
            for mx in range(mw // 16):
                ys = []
                for k in range(4):
                    by, bx = 2 * my + k // 2, 2 * mx + k % 2
                    if by >= ybh:  # dummy row: zeros, DC of the block before the row
                        b = np.zeros(64, np.int64)
                        b[0] = ys[1][0]
                    elif bx >= ybw:  # dummy column: zeros, DC of the block to the left
                        b = np.zeros(64, np.int64)
                        b[0] = ys[k - 1][0]
                    else:
                        b = coefs[0][by, bx]
                    ys.append(b)
                blocks += [(b, 0, DC_LUMA, AC_LUMA) for b in ys]
                blocks += [(coefs[c][my, mx], c, DC_CHROMA, AC_CHROMA) for c in (1, 2)]
    nc = 1 if grey else 3
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in range(1 if grey else 2):
        out += b"\xff\xdb\x00\x43" + bytes([t]) + bytes(int(v) for v in qs[t][ZIGZAG])
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * nc, 8, h, w, nc)
    for c in range(nc):
        out += bytes([c + 1, 0x22 if (c == 0 and not grey) else 0x11, min(c, 1)])
    for cls, tid, (bits, vals) in ([(0, 0, DC_LUMA), (1, 0, AC_LUMA)]
                                   + ([] if grey else [(0, 1, DC_CHROMA), (1, 1, AC_CHROMA)])):
        out += b"\xff\xc4" + struct.pack(">HB", 19 + len(vals), (cls << 4) | tid)
        out += bytes(bits) + bytes(vals)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for c in range(nc):
        out += bytes([c + 1, 0x00 if c == 0 else 0x11])
    out += b"\x00\x3f\x00" + huffman_encode(blocks) + b"\xff\xd9"
    return bytes(out)
