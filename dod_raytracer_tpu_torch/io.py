"""Host-side image I/O: a minimal PNG writer and reader on zlib and numpy.

Counterpart of ``dod_raytracer_tpu.io`` (the reference's stb_image_write
call, ``main.cpp:396``) without Pillow.  ``write_png`` writes 8-bit RGB,
filter 0 on every row, one zlib-compressed IDAT chunk; ``read_png``
decodes the 8-bit, non-interlaced PNG files other writers produce too.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG (stbi_write_png equivalent)."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) ->
    (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data too short ({len(raw)} of {h * (stride + 1)} bytes)")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum over each byte of a pixel
            cur = np.zeros(stride + bpp, np.uint8)
            cur[bpp:] = line
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[bpp:]
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte waits for its left neighbour
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG file -> (H, W, 3) uint8, as Pillow's
    ``Image.open(path).convert("RGB")`` gives it.

    Reads bit depth 8 in colour types 0 (grey), 2 (RGB), 3 (palette, with
    its ``PLTE``), 4 (grey + alpha) and 6 (RGBA), non-interlaced, with
    all five row filters.  Alpha is dropped and grey spread to three
    channels; a ``tRNS`` chunk is ignored.  Raises ``ValueError``, naming
    the file and the reason, on any other bit depth (16-bit among them),
    on interlaced files, and on damaged ones: a bad signature or chunk
    CRC, a missing chunk, data cut short, or a palette index past the
    palette.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos, header, palette, idat, ended = 8, None, None, [], False
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError(f"{path}: chunk {kind!r} cut short")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{path}: IHDR of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
            break
    if header is None or not idat or not ended:
        raise ValueError(f"{path}: damaged PNG (no {'IHDR' if header is None else 'IDAT' if not idat else 'IEND'})")
    w, h, depth, color, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (only 8)")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {color}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not supported")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: damaged image data ({e})") from None
    ch = _CHANNELS[color]
    px = _unfilter(raw, h, w * ch, ch, path).reshape(h, w, ch)
    if color == 3:
        if int(px.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{path}: palette index past the {palette.shape[0]}-entry palette")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
