"""Dependency-free PNG decode/encode (numpy + zlib).

Counterpart of ``raytracer_tpu/pngio.py``: the scanlines are unfiltered by
the native library (``native.png_unfilter``, ``csrc/rtnative.c``) when it
builds, else by the pure-Python loop ``_unfilter_py``.

TPU-native replacement for the reference's libpng asset loader
(reference: src/assets.cc:11-58), which normalizes palette / grayscale / 16-bit /
tRNS images to RGBA8.  We support the same input classes for non-interlaced PNGs.
The reference's CPU loader has a duplicated inner-loop bug (assets.cc:92-93) that
reads width^2 pixels per row; that bug is intentionally NOT replicated.

Also provides an encoder so renders can be dumped as PNGs (the reference displays
frames in an SDL window instead; a framebuffer file dump is the TPU-friendly analog).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _unfilter_py(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Pure-Python PNG scanline unfiltering."""
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for y in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=off + 1).copy()
        off += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for x in range(bpp, stride):
                line[x] = (int(line[x]) + int(line[x - bpp])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - bpp]) if x >= bpp else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                left = int(line[x - bpp]) if x >= bpp else 0
                ul = int(prev[x - bpp]) if x >= bpp else 0
                line[x] = (
                    int(line[x])
                    + int(_paeth(np.uint8(left), np.uint8(prev[x]), np.uint8(ul)))
                ) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to an RGBA8 array of shape [H, W, 4]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG file")

    width = height = bitdepth = colortype = interlace = None
    idat = []
    palette = None
    trns = None
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    raw = zlib.decompress(b"".join(idat))

    if bitdepth == 8:
        bpp = channels
        stride = width * channels
    elif bitdepth == 16:
        bpp = channels * 2
        stride = width * channels * 2
    elif bitdepth in (1, 2, 4):
        if colortype not in (0, 3):
            raise ValueError(f"{path}: bitdepth {bitdepth} with colortype {colortype}")
        bpp = 1
        stride = (width * bitdepth + 7) // 8
    else:
        raise ValueError(f"{path}: unsupported bitdepth {bitdepth}")

    from . import native

    out = native.png_unfilter(raw, height, stride, bpp)
    if out is None:
        out = _unfilter_py(raw, height, stride, bpp)

    # Expand to samples.
    if bitdepth in (1, 2, 4):
        # Unpack sub-byte samples, MSB first.
        nbits = bitdepth
        factor = 255 // ((1 << nbits) - 1) if colortype == 0 else 1
        samples = np.zeros((height, width), dtype=np.uint8)
        for y in range(height):
            row = out[y]
            bitpos = 0
            for x in range(width):
                byte = row[bitpos >> 3]
                shift = 8 - nbits - (bitpos & 7)
                samples[y, x] = ((byte >> shift) & ((1 << nbits) - 1)) * factor
            # advance per pixel
                bitpos += nbits
        img = samples[..., None]
    elif bitdepth == 16:
        arr = out.reshape(height, width, channels, 2)
        img = arr[..., 0]  # take the high byte, same normalization libpng strip_16 does
    else:
        img = out.reshape(height, width, channels)

    # Normalize to RGBA8.
    if colortype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        idx = img[..., 0]
        rgb = palette[idx]
        alpha = np.full((height, width, 1), 255, dtype=np.uint8)
        if trns is not None:
            amap = np.full(palette.shape[0], 255, dtype=np.uint8)
            amap[: trns.shape[0]] = trns
            alpha = amap[idx][..., None]
        rgba = np.concatenate([rgb, alpha], axis=-1)
    elif colortype == 0:
        g = img[..., :1]
        rgba = np.concatenate([g, g, g, np.full_like(g, 255)], axis=-1)
    elif colortype == 4:
        g = img[..., :1]
        a = img[..., 1:2]
        rgba = np.concatenate([g, g, g, a], axis=-1)
    elif colortype == 2:
        a = np.full((height, width, 1), 255, dtype=np.uint8)
        rgba = np.concatenate([img, a], axis=-1)
    else:  # 6
        rgba = img
    return np.ascontiguousarray(rgba)


def read_png_rgba_f32(path: str) -> np.ndarray:
    """Decode to float32 RGBA in [0, 1], matching the GPU atlas normalization
    (reference: src/assets.cc:61-81)."""
    return read_png(path).astype(np.float32) / np.float32(255.0)


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """Encode an RGB(A)8 (or float in [0,1]) array of shape [H, W, 3|4] to
    PNG bytes (in-memory; the live viewer streams these)."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    h, w, c = arr.shape
    colortype = {1: 0, 3: 2, 4: 6}[c]
    raw = bytearray()
    for y in range(h):
        raw.append(0)
        raw.extend(arr[y].tobytes())
    comp = zlib.compress(bytes(raw), level)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        body = ctype + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colortype, 0, 0, 0)
    return (_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", comp)
            + chunk(b"IEND", b""))


def write_png(path: str, rgba: np.ndarray) -> None:
    """Encode an RGB(A)8 (or float in [0,1]) array of shape [H, W, 3|4] as a PNG."""
    with open(path, "wb") as fh:
        fh.write(encode_png(rgba))
