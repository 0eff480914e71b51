"""Image decoding with zlib and numpy (a frozen copy of the decoders in
the port's ``formats/image.py``).

The formats MMD models ship with decode here, each to the (h, w, 4) uint8
RGBA array that PIL's ``Image.open(path).convert("RGBA")`` gives:

* PNG: bit depth 8, colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey
  and alpha) and 6 (RGBA), not interlaced, every row filter, with a
  ``tRNS`` chunk for types 0, 2 and 3;
* BMP: 8-bit palette, 24-bit and 32-bit, uncompressed (32-bit also with
  the BGRX and BGRA bit fields), rows bottom-up or top-down; as in PIL, an
  uncompressed 32-bit file's fourth byte is not alpha;
* TGA: image types 2 (raw) and 10 (run-length), 24-bit and 32-bit, every
  origin.

:func:`load_image` returns None for a missing file, as the JAX package
does. A file in another format, or one these decoders reject, goes to PIL
when PIL can be imported (None where PIL fails too, as in the JAX
package); without PIL it warns once, naming the file, and loads as
missing.
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_warned: set[str] = set()


class UnsupportedImage(ValueError):
    """A file these decoders do not read (PIL may)."""


def load_image(path: str) -> np.ndarray | None:
    """(h, w, 4) uint8 RGBA of the image at ``path``, or None."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data, path)
    except (ValueError, IndexError, struct.error, zlib.error) as e:
        reason = e
    try:
        from PIL import Image
    except ImportError:
        if path not in _warned:
            _warned.add(path)
            warnings.warn(f"texture {path!r} not decoded ({reason}) and PIL is not "
                          "installed: it loads as missing", stacklevel=2)
        return None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:
        return None


def decode_image(data: bytes, name: str = "") -> np.ndarray:
    """Decode PNG, BMP or TGA bytes (TGA by ``name``'s extension, as the
    format has no signature) -> (h, w, 4) uint8 RGBA."""
    if data.startswith(_PNG_MAGIC):
        return decode_png(data)
    if data.startswith(b"BM"):
        return decode_bmp(data)
    if name.lower().endswith(".tga"):
        return decode_tga(data)
    raise UnsupportedImage("not PNG, BMP or TGA")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def decode_png(data: bytes) -> np.ndarray:
    pos, chunks, idat = len(_PNG_MAGIC), {}, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + n
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        else:
            chunks.setdefault(kind, body)
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise UnsupportedImage(f"PNG bit depth {depth}, colour type {ctype}, "
                               f"interlace {interlace}")
    bpp = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * bpp + 1):
        raise ValueError("PNG image data too short")
    px = _unfilter(raw, h, w, bpp)
    trns = chunks.get(b"tRNS")
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        plte = np.frombuffer(chunks[b"PLTE"], np.uint8).reshape(-1, 3)
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(plte), :3] = plte[:256]
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[px[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    out[..., 3] = px[..., -1] if ctype in (4, 6) else 255
    if trns is not None and ctype in (0, 2):
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns))
        hit = (px[..., :len(key)] == key).all(-1) if key.max() < 256 else False
        out[..., 3] = np.where(hit, 0, out[..., 3])
    return out


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters -> (h, w, bpp) uint8.

    Rows filtered None, Sub or Up reconstruct a row at a time. A row
    filtered Average or Paeth depends on the pixel to its left, so an image
    with one reconstructs by anti-diagonals: pixel (y, x) needs (y, x-1),
    (y-1, x) and (y-1, x-1), all on earlier diagonals, so each diagonal is
    one vectorized step, h + w - 1 steps in all."""
    rows = np.frombuffer(raw, np.uint8, h * (w * bpp + 1)).reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int64)
    # recon[y + 1, x + 1] is pixel (y, x); row 0 and column 0 stay zero
    recon = np.zeros((h + 1, w + 1, bpp), np.int64)
    if (ftype <= 2).all():
        for y in range(h):
            f = filt[y]
            if ftype[y] == 1:
                f = np.cumsum(f, axis=0)
            elif ftype[y] == 2:
                f = f + recon[y, 1:]
            recon[y + 1, 1:] = f & 255
        return recon[1:, 1:].astype(np.uint8)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = recon[ys + 1, xs]
        b = recon[ys, xs + 1]
        c = recon[ys, xs]
        ft = ftype[ys][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        recon[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return recon[1:, 1:].astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

_BMP_HEADERS = (40, 52, 56, 64, 108, 124)
_BGRX = (0xFF0000, 0xFF00, 0xFF, 0x0)
_BGRA = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)


def decode_bmp(data: bytes) -> np.ndarray:
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize not in _BMP_HEADERS:
        raise UnsupportedImage(f"BMP header of {hsize} bytes")
    w, h_raw, _planes, bits, comp, _size, _ppm_x, _ppm_y, colors = struct.unpack_from(
        "<iIHHIIiiI", data, 18)
    top_down = data[25] == 0xFF
    h = 2 ** 32 - h_raw if top_down else h_raw
    pos = 14 + hsize
    alpha = False
    if comp == 3 and bits == 32:
        if hsize >= 56:
            masks = struct.unpack_from("<4I", data, 54)
        elif hsize == 52:
            masks = struct.unpack_from("<3I", data, 54) + (0,)
        else:
            masks = struct.unpack_from("<3I", data, pos) + (0,)
            pos += 12
        if masks not in (_BGRX, _BGRA):
            raise UnsupportedImage(f"BMP bit fields {masks}")
        alpha = masks == _BGRA
    elif comp != 0 or bits not in (8, 24, 32):
        raise UnsupportedImage(f"BMP of {bits} bits, compression {comp}")
    if w <= 0 or h <= 0:
        raise ValueError("BMP size")
    colors = colors or (1 << bits if bits <= 8 else 0)
    if bits == 8 and offset == 14 + hsize:
        offset += 4 * colors
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if bits == 8:
        idx = rows[:, :w]
        pal = np.frombuffer(data, np.uint8, 4 * colors, pos).reshape(colors, 4)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all((pal[i] == v).all() for i, v in enumerate(ramp)):  # PIL reads it as grey
            out[..., :3] = idx[..., None]
        else:
            lut = np.zeros((256, 3), np.uint8)
            lut[:min(colors, 256)] = pal[:256]
            out[..., :3] = lut[idx]
        return out
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    out[..., :3] = px[..., 2::-1]
    if alpha:
        out[..., 3] = px[..., 3]
    return out


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def decode_tga(data: bytes) -> np.ndarray:
    id_len, cmap_type, itype = data[0], data[1], data[2]
    _cmap_first, cmap_len, cmap_depth = struct.unpack_from("<HHB", data, 3)
    w, h, depth, flags = struct.unpack_from("<HHBB", data, 12)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise ValueError("not a TGA file")
    if itype not in (2, 10) or depth not in (24, 32):
        raise UnsupportedImage(f"TGA image type {itype}, {depth} bits")
    pos = 18 + id_len
    if cmap_type:
        if cmap_depth not in (16, 24, 32):
            raise ValueError(f"TGA colour map depth {cmap_depth}")
        pos += cmap_len * (cmap_depth // 8)
    bpp = depth // 8
    n = w * h * bpp
    if itype == 2:
        px = np.frombuffer(data, np.uint8, n, pos)
    else:
        px, out_pos = bytearray(n), 0
        while out_pos < n:
            head = data[pos]
            count = ((head & 0x7F) + 1) * bpp
            if head & 0x80:
                chunk = data[pos + 1:pos + 1 + bpp] * ((head & 0x7F) + 1)
                pos += 1 + bpp
            else:
                chunk = data[pos + 1:pos + 1 + count]
                pos += 1 + count
            if len(chunk) != count:
                raise ValueError("TGA run past the data")
            px[out_pos:out_pos + count] = chunk[:n - out_pos]
            out_pos += count
        px = np.frombuffer(bytes(px), np.uint8)
    px = px.reshape(h, w, bpp)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:  # right-to-left columns
        px = px[:, ::-1]
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = px[..., 2::-1]
    out[..., 3] = px[..., 3] if bpp == 4 else 255
    return out


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


GIF_LEVELS = (6, 7, 6)


