"""The port's readers on the inputs that the JAX package reads through
imageio: Adam7-interlaced PNG and 16-bit binary PGM/PPM.

PIL writes no interlaced PNG, so the test builds them with zlib and the
small encoder below (each of the seven passes a small image of its own,
its rows filtered with every one of the five filters in turn), and the
16-bit PGM/PPM files by hand.  Each is read by `read_image` and
`read_png` and held against the source samples and against
`imageio.v3.imread`.  PIL gives 8-bit samples for 16-bit colour (PNG
and PPM) and rescales a PGM whose maxval is not 65535, where the port
keeps the stored integer values as the reference's iio does; those
cases are held to the source, and imageio's values to PIL's rule.
"""

import struct
import zlib

import imageio.v3 as iio
import numpy as np
import pytest

from tpuflow_torch.io import read_image, read_pgm
from tpuflow_torch.io.image import read_png

# Adam7 (PNG spec 8.2): first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _filtered(rows, bpp, first_filter):
    """Rows (h, rowbytes) uint8, row r filtered with filter
    (first_filter + r) % 5, each led by its type (PNG spec 9.2)."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        ftype = (first_filter + r) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        else:
            pred = [0, a, prev, (a + prev) // 2][ftype]
        out += bytes([ftype]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(samples, depth):
    """(h, w, c) samples -> (h, rowbytes) uint8 scanlines."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _adam7_png(arr, depth):
    """An Adam7-interlaced PNG of gray (h, w) or (h, w, c) samples."""
    arr = arr if arr.ndim == 3 else arr[:, :, None]
    h, w, c = arr.shape
    bpp = max(1, c * depth // 8)
    body = b""
    for k, (y0, x0, dy, dx) in enumerate(ADAM7):
        sub = arr[y0::dy, x0::dx]
        if sub.size:  # an empty pass stores nothing, not even filter bytes
            body += _filtered(_pack(sub, depth), bpp, k)

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 1))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def _samples(seed, shape, depth):
    hi = (1 << depth) - 1
    return np.random.default_rng(seed).integers(0, hi + 1, shape).astype(
        np.uint16 if depth == 16 else np.uint8)


# sizes that leave passes empty (1x1, 3x2), passes of one row or column,
# and sizes that are not a multiple of 8
@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (13, 11), (20, 33)])
def test_adam7_gray8_matches_imageio(shape, tmp_path):
    arr = _samples(0, shape, 8)
    path = str(tmp_path / "g.png")
    open(path, "wb").write(_adam7_png(arr, 8))
    got = read_image(path, gray=False)
    assert np.array_equal(read_png(path), arr)
    np.testing.assert_array_equal(got, iio.imread(path).astype(np.float64))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_adam7_gray16_and_alpha_match_imageio(channels, tmp_path):
    depth = 16 if channels == 1 else 8
    shape = (17, 9) if channels == 1 else (17, 9, channels)
    arr = _samples(channels, shape, depth)
    path = str(tmp_path / "a.png")
    open(path, "wb").write(_adam7_png(arr, depth))
    assert np.array_equal(read_png(path), arr)
    np.testing.assert_array_equal(read_image(path, gray=False),
                                  iio.imread(path).astype(np.float64))
    # gray=True averages every channel, alpha included, as JAX's read_image
    np.testing.assert_array_equal(
        read_image(path),
        np.asarray(iio.imread(path), np.float64).reshape(17, 9, -1).mean(2))


def test_adam7_rgb16_keeps_sixteen_bits(tmp_path):
    """16-bit RGB, interlaced: the stored samples; PIL, and so imageio,
    rounds them to 8 bits."""
    arr = _samples(3, (11, 14, 3), 16)
    path = str(tmp_path / "c.png")
    open(path, "wb").write(_adam7_png(arr, 16))
    got = read_image(path, gray=False)
    np.testing.assert_array_equal(got, arr)
    assert got.shape == iio.imread(path).shape
    np.testing.assert_array_equal(read_image(path), arr.mean(axis=2))
    # the same samples stored without interlacing read the same
    from tpuflow_torch.io.image import write_png

    write_png(str(tmp_path / "p.png"), arr)
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")),
                                  read_png(path))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_adam7_packed_gray(depth, tmp_path):
    """Sub-byte gray: each pass packs its own rows."""
    arr = _samples(depth, (10, 13), depth)
    path = str(tmp_path / "p.png")
    open(path, "wb").write(_adam7_png(arr, depth))
    assert np.array_equal(read_png(path), arr)
    if depth == 1:  # PIL reads 1-bit gray as bool
        assert np.array_equal(iio.imread(path), arr.astype(bool))


def _pnm(path, magic, arr, maxval):
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + f"\n# a comment\n{w} {h}\n{maxval}\n".encode())
        f.write(arr.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def test_pgm16_matches_imageio(tmp_path):
    arr = _samples(5, (9, 12), 16)
    path = str(tmp_path / "g.pgm")
    _pnm(path, b"P5", arr, 65535)
    got = read_image(path)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, iio.imread(path).astype(np.float64))
    with pytest.raises(ValueError, match="16-bit"):
        read_pgm(path)


@pytest.mark.parametrize("maxval", [300, 1000, 65535])
def test_ppm16_and_pgm_maxval_keep_stored_values(maxval, tmp_path):
    """16-bit PPM at every maxval and PGM below 65535: the stored
    integers.  imageio's are PIL's round(value / maxval * 255) for
    colour and round(value / maxval * 65535) for gray."""
    rng = np.random.default_rng(maxval)
    rgb = rng.integers(0, maxval + 1, (7, 10, 3)).astype(np.uint16)
    gray = rgb[..., 0]
    _pnm(str(tmp_path / "c.ppm"), b"P6", rgb, maxval)
    _pnm(str(tmp_path / "g.pgm"), b"P5", gray, maxval)
    got = read_image(str(tmp_path / "c.ppm"), gray=False)
    np.testing.assert_array_equal(got, rgb)
    np.testing.assert_array_equal(read_image(str(tmp_path / "c.ppm")),
                                  rgb.mean(axis=2))
    np.testing.assert_array_equal(read_image(str(tmp_path / "g.pgm")), gray)
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "c.ppm")),
                                  np.round(rgb / maxval * 255))
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "g.pgm")),
                                  np.round(gray / maxval * 65535))
    with pytest.raises(ValueError, match="16-bit"):
        read_pgm(str(tmp_path / "c.ppm"))


def test_pnm_truncated_and_bad_maxval(tmp_path):
    path = str(tmp_path / "t.pgm")
    open(path, "wb").write(b"P5\n4 3\n65535\n" + bytes(10))
    with pytest.raises(ValueError, match="truncated"):
        read_image(path)
    open(path, "wb").write(b"P5\n4 3\n70000\n" + bytes(24))
    with pytest.raises(ValueError, match="maxval"):
        read_image(path)
