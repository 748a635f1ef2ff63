"""Frame files to 8-bit luma with numpy and the standard library only: PGM
and PPM (P2, P3, P5, P6) and PNG (every colour type and bit depth, not
interlaced), a bilinear resize, and a PNG writer.

The reader gives the bytes of the repository's C++ runtime
(native/vstpu_runtime.cpp: ``decode_pnm``, ``decode_png`` over libpng,
``resize_bilinear``), so switching readers changes no result:

- PNM colour to luma in f32, 0.299 R + 0.587 G + 0.114 B, scaled by
  255 / maxval, rounded half up;
- PNG colour to luma as libpng's ``png_set_rgb_to_gray(0.299, 0.587)``
  does it: 15-bit fixed-point weights 9797, 19234 and 3737, truncated at 8
  bits, rounded at 16 bits before the low byte is stripped, a grey pixel
  (R = G = B) kept as it is; where an 8-bit file carries a gAMA or sRGB
  chunk, through libpng's 8-bit gamma tables (16-bit files with a gamma
  chunk are read without them). Palettes expand to RGB first; alpha is dropped;
  grey at 1, 2 or 4 bits scales to 8;
- the resize in f32 with pixel-centre sampling (cv::resize INTER_LINEAR's
  convention), rounded half up.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's fixed-point luma weights for (0.299, 0.587): floor(w * 32768)
# of the weights in units of 1e-5, blue the rest of 32768.
_RC, _GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_gray(path: str) -> np.ndarray:
    """The file's luma, u8 [h, w], at its own size."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"P":
        return _decode_pnm(data)
    return _decode_png(data)


def decode_image(path: str, width: int, height: int) -> np.ndarray:
    """u8 [height, width] luma of an image file, resized bilinearly."""
    return resize_bilinear(read_gray(path), width, height)


def resize_bilinear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """u8 to u8 bilinear resize, f32 arithmetic in the C++ runtime's
    order."""
    sh, sw = src.shape
    if (sw, sh) == (width, height):
        return src.copy()
    f32 = np.float32

    def axis(n_dst, n_src):
        s = f32(n_src) / f32(n_dst)
        f = (np.arange(n_dst, dtype=f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.trunc(f).astype(np.int64)
        neg = f < 0
        f = np.where(neg, f32(0.0), f)
        i0 = np.minimum(np.where(neg, 0, i0), n_src - 2)
        return i0, (f - i0.astype(f32)).astype(f32)

    y0, wy = axis(height, sh)
    x0, wx = axis(width, sw)
    img = src.astype(f32)
    r0, r1 = img[y0], img[y0 + 1]
    wx, wy = wx[None, :], wy[:, None]
    one = f32(1.0)
    top = (one - wx) * r0[:, x0] + wx * r0[:, x0 + 1]
    bot = (one - wx) * r1[:, x0] + wx * r1[:, x0 + 1]
    v = (one - wy) * top + wy * bot
    return (v + f32(0.5)).astype(np.uint8)


def _luma_rounded(v):
    """The C++ runtime's f32 to u8: v + 0.5 clamped to [0, 255],
    truncated."""
    f32 = np.float32
    out = np.where(v + f32(0.5) > f32(255.0), f32(255.0),
                   np.where(v < 0, f32(0.0), v + f32(0.5)))
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# PGM / PPM
# ---------------------------------------------------------------------------


def _decode_pnm(data: bytes) -> np.ndarray:
    pos = 0
    n = len(data)

    def skip_space(p):
        while p < n and data[p:p + 1].isspace():
            p += 1
        return p

    pos = skip_space(pos)
    magic = data[pos:pos + 2]
    pos += 2
    if len(magic) != 2 or magic[:1] != b"P" or magic[1:] not in b"23456":
        raise ValueError("not a PNM file")
    ascii_ = magic[1:] in b"23"
    color = magic[1:] in b"36"

    def next_int(p):
        while True:
            if p >= n:
                raise ValueError("truncated PNM header")
            c = data[p:p + 1]
            if c == b"#":
                while p < n and data[p:p + 1] != b"\n":
                    p += 1
            elif not c.isspace():
                break
            else:
                p += 1
        q = p + (data[p:p + 1] in b"+-")
        while q < n and data[q:q + 1].isdigit():
            q += 1
        return int(data[p:q]), q

    w, pos = next_int(pos)
    h, pos = next_int(pos)
    maxv, pos = next_int(pos)
    if w <= 0 or h <= 0 or maxv <= 0 or maxv > 65535:
        raise ValueError("bad PNM header")
    pos += 1  # the single whitespace after maxval
    ch = 3 if color else 1
    count = w * h * ch
    if ascii_:
        px = np.array(data[pos:].split()[:count], dtype=np.int64)
    elif maxv < 256:
        px = np.frombuffer(data, np.uint8, count, pos)
    else:
        px = np.frombuffer(data, ">u2", count, pos)
    if px.size != count:
        raise ValueError("truncated PNM raster")
    px = px.astype(np.uint16).astype(np.float32).reshape(h, w, ch)
    f32 = np.float32
    if color:
        v = (f32(0.299) * px[..., 0] + f32(0.587) * px[..., 1]
             + f32(0.114) * px[..., 2])
    else:
        v = px[..., 0]
    v = v * (f32(255.0) / f32(maxv))
    return _luma_rounded(v)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int):
    """Undoes the per-row PNG filters: [height, stride] u8."""
    rows = raw.reshape(height, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError("bad PNG filter type")
    if np.all(kinds <= 2):
        out = np.zeros((height, stride), np.int32)
        prev = np.zeros(stride, np.int32)
        for y in range(height):
            row = data[y]
            if kinds[y] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
            elif kinds[y] == 2:
                row = row + prev
            prev = out[y] = row & 255
        return out.astype(np.uint8)
    # Average and Paeth predict from the left, upper and upper-left bytes:
    # reconstruct along anti-diagonals of the (row, pixel) lattice, each
    # a vectorised step, every byte lane of a pixel at once.
    nx = stride // bpp
    d = data.reshape(height, nx, bpp)
    out = np.zeros((height + 1, nx + 1, bpp), np.int32)
    for diag in range(height + nx - 1):
        ys = np.arange(max(0, diag - nx + 1), min(height, diag + 1))
        xs = diag - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        k = kinds[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (d[ys, xs] + pred) & 255
    return out[1:, 1:].reshape(height, stride).astype(np.uint8)


def _gamma_table(exponent):
    """libpng's png_build_8bit_table at an exponent in units of 1e-5:
    identity where the exponent is within 5% of 1, else
    floor(255 (v / 255)^e + 0.5) for 0 < v < 255."""
    v = np.arange(256)
    if abs(exponent - 100000) <= 5000:
        return v
    out = np.floor(255.0 * np.power(v / 255.0, exponent * 1e-5) + 0.5)
    out = out.astype(np.int64)
    out[0], out[255] = 0, 255
    return out


def _reciprocal(fixed):
    """libpng's png_reciprocal: 1e10 / fixed, rounded."""
    return int(math.floor(1e10 / fixed + 0.5))


def _decode_png(data: bytes) -> np.ndarray:
    idat, plte, trns, gamma = [], None, None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"gAMA":
            gamma = struct.unpack(">I", body)[0]
        elif kind == b"sRGB":
            gamma = 45455
        elif kind == b"IDAT":
            idat.append(body)
    del trns  # alpha, from tRNS or a channel, is dropped
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[:h * (stride + 1)], h, stride, bpp)
    if depth == 16:
        samples = rows.view(">u2").reshape(h, w, ch).astype(np.int64)
    elif depth == 8:
        samples = rows.reshape(h, w, ch).astype(np.int64)
    else:
        bits_ = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bits_ * weights).sum(-1)[:, :w, None].astype(np.int64)
    if ctype == 3:
        rgb = plte[samples[..., 0]].astype(np.int64)
        return _rgb_to_gray(rgb, 8, gamma)
    if ctype == 0 and depth < 8:
        samples = samples * (255 // ((1 << depth) - 1))
    if ctype in (2, 6):
        return _rgb_to_gray(samples[..., :3], depth, gamma)
    gray = samples[..., 0]
    return (gray >> 8 if depth == 16 else gray).astype(np.uint8)


def _rgb_to_gray(rgb, depth, gamma):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    same = (r == g) & (r == b)
    if gamma is not None and abs(gamma - 100000) > 5000 and depth == 8:
        # libpng builds gamma tables when the file's gamma is significant:
        # to linear with 1/gamma, back with the screen's (its default, the
        # file's own) gamma; a grey pixel passes through an identity.
        to_1 = _gamma_table(_reciprocal(gamma))
        from_1 = _gamma_table(_reciprocal(_reciprocal(gamma)))
        mixed = from_1[(_RC * to_1[r] + _GC * to_1[g] + _BC * to_1[b]
                        + 16384) >> 15]
    elif depth == 16:
        # libpng rounds at 16 bits (png_do_rgb_to_gray's 16-bit branch).
        mixed = (_RC * r + _GC * g + _BC * b + 16384) >> 15
    else:
        mixed = (_RC * r + _GC * g + _BC * b) >> 15
    gray = np.where(same, r, mixed)
    return (gray >> 8 if depth == 16 else gray).astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Writes u8 [h, w] (grey) or [h, w, 3] (RGB) as an 8-bit PNG, each
    row filtered with "Up"."""
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1).astype(np.int16)
    up = (rows - np.vstack([np.zeros_like(rows[:1]), rows[:-1]])) & 255
    raw = np.hstack([np.full((h, 1), 2, np.uint8), up.astype(np.uint8)])

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
