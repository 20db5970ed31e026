"""io/png.py against PIL (what the JAX package's data/bop.py reads and
writes with) and OpenCV's libpng, bitwise: 16-bit depth and 8-bit
frames of tools/scenes.py and seeded noise, every row filter."""

import pathlib
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from object_detector_6d_tpu_torch.io.png import read_png, write_png

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

FILTERS = {"none": 0, "sub": 1, "up": 2, "avg": 3, "paeth": 4}


def _images():
    dep, gray, mask = scenes.snowman_scene()
    d2, _, g2 = scenes.render_translated(dep, mask, scenes.K_DEFAULT,
                                         np.array([0.03, -0.01, 0.02]))
    rng = np.random.RandomState(0)
    return {
        "depth16": d2,
        "gray8": g2,
        "bgr8": np.repeat(gray[..., None], 3, 2),
        "noise16": rng.randint(0, 65536, (37, 53), dtype=np.uint16),
        "noise8": rng.randint(0, 256, (29, 31), dtype=np.uint8),
        "noise_rgb8": rng.randint(0, 256, (37, 53, 3), dtype=np.uint8),
        "noise_rgba8": rng.randint(0, 256, (23, 41, 4), dtype=np.uint8),
        "noise_rgb16": rng.randint(0, 65536, (19, 27, 3), dtype=np.uint16),
    }


IMAGES = _images()


def _row_filters(path) -> set:
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, -1)
    return set(raw[:, 0].tolist())


def _cv2_order(a):
    """cv2 stores a 3 / 4 channel array as BGR(A): reverse the colour
    channels so that the file holds ``a``'s channel order."""
    if a.ndim == 3:
        return np.ascontiguousarray(a[..., [2, 1, 0, 3][:a.shape[2]]])
    return a


@pytest.mark.parametrize("flt", sorted(FILTERS))
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_reads_libpng_files_with_each_filter(tmp_path, name, flt):
    a = IMAGES[name]
    p = str(tmp_path / "cv.png")
    cv2.imwrite(p, _cv2_order(a),
                [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{flt.upper()}")])
    assert FILTERS[flt] in _row_filters(p)
    got = read_png(p)
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


# PIL writes no 16-bit colour PNG
@pytest.mark.parametrize("name", sorted(n for n in IMAGES if n != "noise_rgb16"))
def test_reads_what_pil_writes(tmp_path, name):
    a = IMAGES[name]
    p = str(tmp_path / "pil.png")
    Image.fromarray(a).save(p)  # adaptive filtering
    np.testing.assert_array_equal(read_png(p), a)
    np.testing.assert_array_equal(read_png(p), np.asarray(Image.open(p)).astype(a.dtype))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_written_files_read_back_by_pil_and_libpng(tmp_path, name):
    a = IMAGES[name]
    p = str(tmp_path / "ours.png")
    write_png(p, a)
    assert _row_filters(p) == {0}
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), _cv2_order(a))
    if not (a.ndim == 3 and a.dtype == np.uint16):
        np.testing.assert_array_equal(np.asarray(Image.open(p)).astype(a.dtype), a)
    np.testing.assert_array_equal(read_png(p), a)


def test_paletted_and_interlaced_files_raise(tmp_path):
    p = str(tmp_path / "pal.png")
    Image.fromarray(IMAGES["noise8"]).convert("P").save(p)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(p)
    # an interlaced header: IHDR's last byte set to 1 (Adam7)
    q = str(tmp_path / "ours.png")
    write_png(q, IMAGES["noise8"])
    data = bytearray(open(q, "rb").read())
    ihdr = bytes(data[12:29])[:-1] + b"\x01"
    data[12:29] = ihdr
    data[29:33] = struct.pack(">I", zlib.crc32(ihdr))
    open(q, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(q)
