"""Image bytes -> a 2-D uint8 grey array, without PIL for PNG.

Serving and the datasets take rendered-equation PNGs. ``decode_image`` reads
non-interlaced PNGs of every bit depth the format allows (grey at 1, 2, 4, 8
and 16 bits, palette at 1, 2, 4 and 8, RGB, grey and alpha, and RGBA at 8
and 16) with the standard library (``zlib``, ``struct``) and numpy, undoing
the five row filters, and turns them into grey as PIL's ``convert("L")``
does: grey below 8 bits scaled to 0..255 (``v * 255 // (2**depth - 1)``),
16-bit grey clipped at 255, 16-bit colour and alpha samples cut to their
high byte, colour to integer luma ``(R * 19595 + G * 38470 + B * 7471 +
0x8000) >> 16``, a palette through its RGB entries, alpha dropped. Any other
image (an interlaced PNG, another format) goes to PIL, imported only then;
without PIL it raises ``ValueError`` naming the format. ``png_size`` reads a
PNG's width and height from its header alone.

``encode_png`` writes an (H, W) grey or (H, W, 3) RGB uint8 array as an 8-bit
PNG (every row unfiltered, zlib-compressed), also with the standard library
only.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples per pixel, per colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"))


class UnsupportedPNG(ValueError):
    """A PNG this reader does not decode (bit depth, interlace)."""


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of the
    decompressed scanlines -> (height, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < height * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = data[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of a pixel, mod 256
            cur = np.empty(stride, np.uint8)
            for i in range(bpp):
                cur[i::bpp] = np.cumsum(line[i::bpp], dtype=np.uint64).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_sequential(kind, line.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_sequential(kind: int, f: list, up: list, bpp: int) -> np.ndarray:
    """One Average (3) or Paeth (4) row: each byte adds its predictor from the
    byte a pixel to its left (a), the byte above (b) and above-left (c). The
    first pixel has a = c = 0, where both predictors reduce to b (halved for
    Average)."""
    cur = bytearray(len(f))
    for x in range(bpp):
        cur[x] = (f[x] + (up[x] >> (kind == 3))) & 0xFF
    if kind == 3:
        for x in range(bpp, len(f)):
            cur[x] = (f[x] + ((cur[x - bpp] + up[x]) >> 1)) & 0xFF
    else:  # Paeth, with p = a + b - c: |p - a| = |b - c|, |p - b| = |a - c|
        for x in range(bpp, len(f)):
            a, b, c = cur[x - bpp], up[x], up[x - bpp]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - c - c)
            cur[x] = (f[x] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def png_size(data: bytes) -> tuple:
    """(width, height) from a PNG's IHDR chunk: its first 24 bytes are
    enough. Raises ``ValueError`` if they are not a PNG's."""
    if len(data) < 24 or not data.startswith(PNG_SIGNATURE) or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> (H, W, channels) samples: unpacked from the bits
    of a byte below 8 bits, big-endian uint16 at 16."""
    height = rows.shape[0]
    if depth == 8:
        return rows.reshape(height, width, channels)
    if depth == 16:
        pairs = rows.reshape(height, width, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits @ weights)[:, :width, None]


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced PNG -> (H, W) uint8 grey, as PIL's ``convert("L")``
    gives it. Raises ``UnsupportedPNG`` for an interlaced image or a bit
    depth the colour type does not allow, and ``ValueError`` for a
    malformed file."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace != 0 or depth not in _DEPTHS.get(colour, ()):
        raise UnsupportedPNG(f"PNG of bit depth {depth}, colour type {colour}, "
                             f"interlace {interlace}")
    channels = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    bits = depth * channels  # per pixel; the filters step by whole bytes, at least one
    rows = _unfilter(raw, height, (width * bits + 7) // 8, max(1, bits // 8))
    pixels = _samples(rows, width, depth, channels)
    if depth == 16:  # as PIL: grey clipped at 255, any other sample cut to its high byte
        pixels = (np.minimum(pixels, 255) if colour == 0 else pixels >> 8).astype(np.uint8)
    elif depth < 8 and colour == 0:
        pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    if colour in (0, 4):
        return np.ascontiguousarray(pixels[..., 0])
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        index = pixels[..., 0]
        if int(index.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return _luma(palette)[index]
    return _luma(pixels)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W) grey or (H, W, 3) RGB uint8 array -> 8-bit PNG bytes (colour
    type 0 or 2, rows unfiltered). ``decode_png`` reads a grey PNG back
    exactly, and an RGB one as its luma."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                          and image.shape[2] == 3)):
        raise ValueError(f"expected an (H, W) or (H, W, 3) uint8 array, got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    colour = 0 if image.ndim == 2 else 2
    rows = np.zeros((height, 1 + image[0].size), np.uint8)  # filter byte 0: None
    rows[:, 1:] = image.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def image_format(data: bytes) -> str:
    """The format its magic bytes name, or "unknown"."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> (H, W) uint8 grey. PNGs this module reads are
    decoded here; anything else through PIL if it is installed."""
    fmt = image_format(data)
    if fmt == "PNG":
        try:
            return decode_png(data)
        except UnsupportedPNG:
            pass
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"cannot decode a {fmt} image without PIL "
                         "(8-bit non-interlaced PNG needs none)") from None
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("L"), dtype=np.uint8)
