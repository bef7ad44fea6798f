"""Image IO + preprocessing with exact darknet numerics.

Behavioral port targets (reference ``src/core/yolo_image.cpp``):
- ``load_image_stb``   :167-189  HWC uint8 -> CHW float32 / 255
- ``resize_image``     :84-127   separable bilinear with darknet's edge rule
  (last column copies the last source pixel; the vertical pass skips the
  second tap on the last row)
- ``letterbox_image``  :148-165  integer new_w/new_h, 0.5-gray fill, centered
  embed at ((w-new_w)//2, (h-new_h)//2)

A vectorized numpy implementation (bit-identical to the scalar loops) plus an
optional native C++ fast path (yolotpu/native) for streaming throughput.
"""

from __future__ import annotations

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# samples per pixel by PNG color type: gray, RGB, palette, gray+A, RGBA
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(ftype: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo one scanline's PNG filter in place (PNG spec section 9)."""
    n = len(row)
    if ftype == 1:                                   # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 255
    elif ftype == 2:                                 # Up
        row[:] = ((np.frombuffer(row, np.uint8).astype(np.uint16)
                   + np.frombuffer(prior, np.uint8)) & 255
                  ).astype(np.uint8).tobytes()
    elif ftype == 3:                                 # Average
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((a + prior[i]) >> 1)) & 255
    elif ftype == 4:                                 # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 255
    elif ftype != 0:
        raise ValueError(f"PNG: unknown filter type {ftype}")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (alpha dropped, gray expanded).

    Non-interlaced 8/16-bit gray, RGB, palette, gray+alpha and RGBA —
    zlib + numpy only, no imaging library."""
    import struct
    import zlib
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if interlace or depth not in (8, 16) or ctype not in _PNG_SAMPLES:
        raise ValueError(f"PNG: unsupported format (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    bpp = _PNG_SAMPLES[ctype] * depth // 8
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = bytearray(h * stride)
    prior = bytes(stride)
    for y in range(h):
        row = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        _unfilter(raw[y * (stride + 1)], row, prior, bpp)
        out[y * stride:(y + 1) * stride] = row
        prior = row
    px = np.frombuffer(bytes(out), np.uint8).reshape(h, w, -1)
    if depth == 16:
        px = px[:, :, 0::2]                       # big-endian high bytes
    if ctype == 3:
        return plte[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def encode_png(hwc: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes (filter 0 rows, zlib)."""
    import struct
    import zlib
    hwc = np.ascontiguousarray(hwc, np.uint8)
    h, w = hwc.shape[:2]
    ctype = 2 if hwc.ndim == 3 else 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           hwc.reshape(h, -1)], axis=1)
    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _pil(path: str):
    """PIL's Image module for formats other than PNG."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: only PNG is read and written without PIL; install "
            "Pillow for other image formats") from e
    return Image


def load_rgb(path: str) -> np.ndarray:
    """Image file -> (H, W, 3) uint8 RGB. PNG needs nothing beyond numpy
    and zlib; other formats go through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        return decode_png(data)
    import io
    with _pil(path).open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def save_rgb(hwc: np.ndarray, path: str) -> None:
    """(H, W, 3) uint8 -> image file; PNG without PIL, else via PIL."""
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(hwc))
    else:
        _pil(path).fromarray(np.ascontiguousarray(hwc, np.uint8)).save(path)


def load_image(path: str, channels: int = 3) -> np.ndarray:
    """Load an image file to CHW float32 in [0,1] (darknet layout)."""
    hwc = load_rgb(path)
    if channels == 1:
        # ITU-R 601-2 luma, PIL's "L" conversion
        hwc = ((hwc[:, :, 0].astype(np.uint32) * 19595
                + hwc[:, :, 1].astype(np.uint32) * 38470
                + hwc[:, :, 2].astype(np.uint32) * 7471 + 0x8000) >> 16
               ).astype(np.uint8)[:, :, None]
    return (hwc.astype(np.float32) / 255.0).transpose(2, 0, 1)


def save_image(chw: np.ndarray, path: str) -> None:
    """CHW float [0,1] -> image file (save_image_png equivalent)."""
    hwc = np.clip(chw.transpose(1, 2, 0) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if hwc.shape[2] == 1:
        hwc = hwc[:, :, 0]
    save_rgb(hwc, path)


def resize_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Darknet bilinear resize, CHW float32 -> CHW float32 (w, h target).

    Horizontal pass: scale (src_w-1)/(w-1); output col w-1 (or src_w==1)
    copies the last source column. Vertical pass: scale (src_h-1)/(h-1);
    the dy tap is skipped entirely on the last output row.
    """
    c, src_h, src_w = im.shape
    im = im.astype(np.float32)

    # horizontal. Index math is float32 end-to-end to match the C code's
    # ``float sx = c * w_scale`` exactly (f64 here occasionally lands on the
    # other side of an integer boundary, shifting ix/dx by one source pixel).
    if w == 1:
        # darknet's `c == w-1` branch wins at col 0 when w==1: the LAST
        # source column is copied (yolo_image.cpp:93-95)
        part = im[:, :, -1:].copy()
    else:
        w_scale = np.float32(np.float32(src_w - 1) / np.float32(w - 1))
        cols = np.arange(w, dtype=np.float32)
        sx = cols * w_scale
        ix = sx.astype(np.int64)
        dx = (sx - ix.astype(np.float32)).astype(np.float32)
        last = (np.arange(w) == w - 1) | (src_w == 1)
        ix0 = np.where(last, src_w - 1, ix)
        ix1 = np.minimum(ix0 + 1, src_w - 1)
        d = np.where(last, np.float32(0.0), dx).astype(np.float32)
        part = (1 - d) * im[:, :, ix0] + d * im[:, :, ix1]

    # vertical
    if h == 1:
        return part[:, :1, :].astype(np.float32)
    h_scale = np.float32(np.float32(src_h - 1) / np.float32(h - 1))
    rows = np.arange(h, dtype=np.float32)
    sy = rows * h_scale
    iy = np.minimum(sy.astype(np.int64), src_h - 1)
    dy = (sy - iy.astype(np.float32)).astype(np.float32)
    out = (1 - dy)[None, :, None] * part[:, iy, :]
    take2 = ~((rows == h - 1) | (src_h == 1))
    iy1 = np.minimum(iy + 1, src_h - 1)
    out = out + np.where(take2, dy, 0.0)[None, :, None] * part[:, iy1, :]
    return out.astype(np.float32)


def letterbox_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Aspect-preserving resize into a 0.5-gray (w,h) canvas.

    Integer new_w/new_h math matches the reference exactly
    (yolo_image.cpp:150-157): ``new_h = (im_h * w) // im_w`` etc.
    """
    c, im_h, im_w = im.shape
    if w / im_w < h / im_h:
        new_w = w
        new_h = (im_h * w) // im_w
    else:
        new_h = h
        new_w = (im_w * h) // im_h
    resized = resize_image(im, new_w, new_h)
    boxed = np.full((c, h, w), 0.5, dtype=np.float32)
    dy, dx = (h - new_h) // 2, (w - new_w) // 2
    boxed[:, dy:dy + new_h, dx:dx + new_w] = resized
    return boxed


def resize_image_scalar(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Literal loop transcription of resize_image (yolo_image.cpp:84-127)
    for cross-checking the vectorized version in tests."""
    c, src_h, src_w = im.shape
    part = np.zeros((c, src_h, w), np.float32)
    w_scale = np.float32(src_w - 1) / np.float32(w - 1) if w > 1 else np.float32(0)
    h_scale = np.float32(src_h - 1) / np.float32(h - 1) if h > 1 else np.float32(0)
    for k in range(c):
        for r in range(src_h):
            for col in range(w):
                if col == w - 1 or src_w == 1:
                    val = im[k, r, src_w - 1]
                else:
                    sx = np.float32(np.float32(col) * w_scale)
                    ix = int(sx)
                    dx = np.float32(sx - np.float32(ix))
                    val = (1 - dx) * im[k, r, ix] + dx * im[k, r, ix + 1]
                part[k, r, col] = val
    out = np.zeros((c, h, w), np.float32)
    for k in range(c):
        for r in range(h):
            sy = np.float32(np.float32(r) * h_scale)
            iy = int(sy)
            dy = np.float32(sy - np.float32(iy))
            out[k, r, :] = (1 - dy) * part[k, iy, :]
            if r == h - 1 or src_h == 1:
                continue
            out[k, r, :] += dy * part[k, iy + 1, :]
    return out
