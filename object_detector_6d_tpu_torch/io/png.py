"""PNG read / write with zlib, struct and numpy (no imaging library).

The BOP loaders (data/bop.py) read u16 depth and u8 colour frames and the
synthetic scene writes them; the JAX package does this through PIL.

* ``read_png``: 8- and 16-bit greyscale, RGB and RGBA, non-interlaced,
  with any of the five row filters (None, Sub, Up, Average, Paeth).
  16-bit samples are big-endian in the file and come back as native
  uint16. Returns [H, W] or [H, W, C]. A paletted, grey+alpha, sub-byte
  or interlaced file raises ValueError.
* ``write_png``: u8 or u16 [H, W] (greyscale) or [H, W, 3 | 4] (RGB /
  RGBA), every row with filter 0 (None), one IDAT chunk.

Unfiltering runs as a wavefront over the anti-diagonals r + x of the
[rows, pixels] grid: a reconstructed byte depends only on its left, upper
and upper-left neighbours, which lie on earlier anti-diagonals, so each
step is one numpy expression over all rows at once (H + W - 1 steps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_TYPE_OF = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIG)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG: no IEND chunk")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Filtered scanlines [H, 1 + W * bpp] -> bytes [H, W, bpp] u8."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {ftype.max()}")
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    # recon with a zero row above and a zero pixel to the left
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a = rec[r + 1, x]  # left
        b = rec[r, x + 1]  # up
        c = rec[r, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """u8 or u16 [H, W] (greyscale) or [H, W, C] (RGB, RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not supported "
                         "(greyscale, RGB and RGBA only; no palette)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported (8 or 16)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {raw.size} image bytes for {H}x{W}x{bpp}")
    px = _unfilter(raw.reshape(H, 1 + W * bpp), H, W, bpp)
    if depth == 16:
        px = px.reshape(H, W * bpp).view(">u2").astype(np.uint16)
    out = px.reshape(H, W, ch)
    return out[..., 0] if ch == 1 else out


def write_png(path: str, img: np.ndarray) -> None:
    """Write u8 / u16 [H, W], [H, W, 3] or [H, W, 4] with filter 0."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes u8 or u16, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or ch not in _TYPE_OF:
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], got {img.shape}")
    H, W = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, depth, _TYPE_OF[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))
