"""PPM (binary P6) and BMP (24/32-bit) image I/O.

Equivalents of the reference's ppm_rw.c / bmp_rw.c, returning canonical
(h, w, 3) uint8 RGB arrays:
  - PPM read rescales sub-8-bit maxval like ppm_read24 (ppm_rw.c:80:
    (x * 255 + maxc/2) / maxc) and rejects maxval > 255;
  - BMP read handles bottom-up row order and row padding (bmp_rw.c:22-61);
  - BMP write emits the same 32-bit BI_RGB header layout as bmp_write24
    (bmp_rw.c:96-146).

The port's own copy of ``ntsc_crt_tpu/utils/imageio.py`` (numpy only; a
test holds the two equal).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def ppm_read(path) -> np.ndarray:
    data = Path(path).read_bytes()

    # header: "P6" whitespace w h maxval, with '#' comments (ppm_rw.c:30-77)
    pos = 0

    def token():
        nonlocal pos
        while pos < len(data):
            c = data[pos:pos + 1]
            if c == b"#":
                while pos < len(data) and data[pos:pos + 1] != b"\n":
                    pos += 1
            elif c.isspace():
                pos += 1
            else:
                break
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        return data[start:pos]

    magic = token()
    if magic != b"P6":
        raise ValueError(f"not a binary PPM (P6): {magic!r}")
    w = int(token())
    h = int(token())
    maxc = int(token())
    if maxc > 255:
        raise ValueError("maxval > 255 unsupported (like ppm_read24)")
    pos += 1  # single whitespace after maxval
    raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    img = raw.reshape(h, w, 3)
    if maxc != 255:
        img = ((img.astype(np.uint32) * 255 + maxc // 2) // maxc).astype(np.uint8)
    return img.copy()


def ppm_write(path, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def bmp_read(path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    data_offset = struct.unpack_from("<I", data, 10)[0]
    hdr_size = struct.unpack_from("<I", data, 14)[0]
    w, h = struct.unpack_from("<ii", data, 18)
    planes, depth = struct.unpack_from("<HH", data, 26)
    comp = struct.unpack_from("<I", data, 30)[0]
    if comp != 0 or depth not in (24, 32):
        raise ValueError(f"unsupported BMP: depth={depth} compression={comp}")
    del hdr_size, planes
    bypp = depth // 8
    flip = h > 0
    h = abs(h)
    stride = (w * bypp + 3) & ~3
    img = np.zeros((h, w, 3), np.uint8)
    for row in range(h):
        src = data_offset + row * stride
        line = np.frombuffer(data, np.uint8, count=w * bypp, offset=src)
        line = line.reshape(w, bypp)
        dst = h - 1 - row if flip else row
        img[dst, :, 0] = line[:, 2]   # BMP stores BGR(A)
        img[dst, :, 1] = line[:, 1]
        img[dst, :, 2] = line[:, 0]
    return img


def bmp_write(path, rgb: np.ndarray) -> None:
    """32-bit BMP like bmp_write24 (bmp_rw.c:96-146)."""
    h, w = rgb.shape[:2]
    img_size = w * h * 4
    hdr = struct.pack("<2sIHHI", b"BM", 54 + img_size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 32, 0, img_size,
                       2835, 2835, 0, 0)
    rows = np.zeros((h, w, 4), np.uint8)
    rows[..., 0] = rgb[..., 2]
    rows[..., 1] = rgb[..., 1]
    rows[..., 2] = rgb[..., 0]
    rows[..., 3] = 0xFF
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(info)
        f.write(rows[::-1].tobytes())  # bottom-up


def read_image(path) -> np.ndarray:
    p = str(path).lower()
    if p.endswith(".ppm"):
        return ppm_read(path)
    if p.endswith(".bmp"):
        return bmp_read(path)
    raise ValueError(f"unsupported image suffix: {path} (ppm/bmp)")


def write_image(path, rgb: np.ndarray) -> None:
    p = str(path).lower()
    if p.endswith(".ppm"):
        ppm_write(path, rgb)
    elif p.endswith(".bmp"):
        bmp_write(path, rgb)
    else:
        raise ValueError(f"unsupported image suffix: {path} (ppm/bmp)")
