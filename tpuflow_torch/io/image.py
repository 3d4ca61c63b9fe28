"""Host-side image IO for the port's CLIs.

Counterpart of tpuflow/io/image.py without imageio or PIL: PNG has its
own codec on `zlib` and `struct`, PGM/PPM and PFM are read and written
as the JAX package does.  IO is a cold path (the reference CLIs read
each image once per run, src/tvl1flow_main.cpp:177-178), so plain numpy
suffices.

Readable formats, chosen by the file's extension (READABLE):

  * PNG (.png): 8- and 16-bit samples (16-bit big-endian, returned as
    their integer values), colour types 0 (gray), 2 (RGB), 3 (palette,
    expanded to RGB as imageio does, tRNS ignored), 4 (gray + alpha) and
    6 (RGBA), bit depths 1/2/4 for gray and palette, all five scanline
    filters, plain or interlaced (Adam7);
  * binary PGM / PPM (.pgm, .ppm, .pnm: P5, P6), 8-bit (maxval <= 255)
    and 16-bit (maxval up to 65535, big-endian samples returned as
    their integer values, as the reference's iio reads them; imageio,
    through PIL, gives the same for 16-bit gray at maxval 65535, and
    rescales other maxvals and 16-bit colour to 8 bits);
  * PFM (.pfm: Pf gray, PF colour), rows stored bottom-up.

Reading returns float arrays, (H, W) or (H, W, C), to mirror
`iio_read_image_double` (reference src/iio.h:83); `gray=True` averages
every channel, alpha included, as tpuflow/io/image.py:24-27 does.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

READABLE = ("PNG (.png)", "binary PGM/PPM (.pgm, .ppm, .pnm)", "PFM (.pfm)")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (PNG spec, IHDR)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type
# Adam7's seven passes (PNG spec 8.2): first row, first column, row
# step, column step
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _unsupported(path, why):
    return ValueError(f"{path}: {why}; the port reads {', '.join(READABLE)}")


def read_image(path, gray=True, dtype=np.float64):
    """Read an image file -> (H, W) if gray else (H, W) or (H, W, C)
    float array."""
    ext = Path(path).suffix.lower()
    if ext == ".png":
        arr = read_png(path)
    elif ext in (".pgm", ".ppm", ".pnm"):
        arr = _read_pnm(path, wide=True)
    elif ext == ".pfm":
        arr = read_pfm(path)
    else:
        raise _unsupported(path, f"cannot read {ext or 'files without an extension'}")
    arr = arr.astype(dtype)
    if gray and arr.ndim == 3:
        arr = arr.mean(axis=2)
    return arr


def write_image(path, arr):
    """Write an array by the extension: PNG (uint8 or uint16 kept, other
    types rounded and clipped to uint8, as tpuflow/io/image.py does),
    binary PGM/PPM (8-bit) or PFM (float32)."""
    ext = Path(path).suffix.lower()
    if ext == ".pfm":
        write_pfm(path, arr)
        return
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    if ext == ".png":
        write_png(path, arr)
    elif ext in (".pgm", ".ppm", ".pnm"):
        write_pgm(path, arr)
    else:
        raise ValueError(f"{path}: cannot write {ext or 'files without an extension'}; "
                         "the port writes .png, .pgm, .ppm, .pnm and .pfm")


# --------------------------------------------------------------------- PNG

def _chunks(data, path):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + payload):
            raise ValueError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter(raw, height, rowbytes, bpp, path):
    """Undo the per-scanline filters (PNG spec 9.2): (height, rowbytes)
    uint8.

    A byte's predictor reads the byte bpp to its left (a), the byte above
    (b) and the one above a (c), so in pixels of bpp bytes pixel (r, x)
    depends only on (r, x-1), (r-1, x) and (r-1, x-1).  All pixels of one
    anti-diagonal r + x = d are undone in one array step, whatever mix of
    filters their rows use: height + width - 1 steps per image.  The
    pixels are held skewed, diagonal d in row d + 2 and image row r at
    column r + 1 (zero-padded), so that a diagonal and its neighbours are
    contiguous slices; the two skewed copies take about
    3 (height + width) height bpp bytes."""
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (rowbytes + 1)).reshape(
        height, rowbytes + 1)
    ftype = rows[:, 0].astype(np.intp)
    present = set(np.unique(ftype).tolist())
    if max(present) > 4:
        raise ValueError(f"{path}: unknown PNG filter type {max(present)}")
    npix = rowbytes // bpp
    ndiag = height + npix - 1
    src = np.zeros((ndiag + 2, height + 1, bpp), np.uint8)
    out = np.zeros(src.shape, np.int16)
    for r in range(height):
        src[r + 2:r + 2 + npix, r + 1] = rows[r, 1:].reshape(npix, bpp)
    ft = np.broadcast_to(ftype[:, None], (height, bpp)).copy()
    for d in range(ndiag):
        lo, hi = max(0, d - npix + 1), min(height, d + 1)
        a, b, c = out[d + 1, lo + 1:hi + 1], out[d + 1, lo:hi], out[d, lo:hi]
        # predictors of the filters the image uses: None, Sub, Up,
        # Average, Paeth (ties to a, then b)
        pred = [0, a, b, 0, 0]
        if 3 in present:
            pred[3] = (a + b) >> 1
        if 4 in present:
            da, db = a - c, b - c
            pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
            pred[4] = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        cur = out[d + 2, lo + 1:hi + 1]
        np.add(src[d + 2, lo + 1:hi + 1], np.choose(ft[lo:hi], pred), out=cur)
        cur &= 0xFF
    res = np.empty((height, npix, bpp), np.uint8)
    for r in range(height):
        res[r] = out[r + 2:r + 2 + npix, r + 1]
    return res.reshape(height, rowbytes)


def _filter_rows(rows, bpp):
    """Filter each scanline of (H, rowbytes) uint8 `rows` (PNG spec 9.2)
    with the filter whose bytes, taken as signed, have the least sum of
    absolute values: the heuristic of PNG spec 12.8 that libpng applies
    to 8- and 16-bit images.  Returns (H, rowbytes + 1) uint8, each row
    led by its filter type."""
    x = rows.astype(np.int16)
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    a, c = np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], c[:, bpp:] = x[:, :-bpp], b[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) & 0xFF
    best = np.minimum(cand, 256 - cand).sum(axis=2).argmin(axis=0)
    chosen = np.take_along_axis(cand, best[None, :, None], 0)[0]
    return np.concatenate([best[:, None], chosen], axis=1).astype(np.uint8)


def _samples(raw, height, width, depth, channels):
    """Unfiltered scanlines (height, rowbytes) uint8 -> (height, width,
    channels) samples: 16-bit big-endian as uint16, 8-bit as they are,
    1/2/4-bit unpacked most significant bits first."""
    if depth == 16:
        samples = raw.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = raw
    else:  # packed gray or palette indices
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            height, -1)[:, :width]
    return samples.reshape(height, width, channels)


def read_png(path):
    """Read a PNG -> (H, W) or (H, W, C) uint8 / uint16 array (palette
    images expanded to RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace not in (0, 1):
        raise _unsupported(path, f"PNG interlace method {interlace}")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and ctype not in (0, 3)) or (depth == 16 and ctype == 3):
        raise _unsupported(path, f"PNG colour type {ctype} at bit depth {depth}")
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    rowbytes = (width * bits + 7) // 8
    data = zlib.decompress(b"".join(idat))
    bpp = max(1, bits // 8)
    if not interlace:
        raw = _unfilter(data, height, rowbytes, bpp, path)
        arr = _samples(raw, height, width, depth, channels)
    else:
        # each Adam7 pass is a small image of its own, filtered and
        # stored after the one before; an empty pass stores nothing
        arr = np.zeros((height, width, channels),
                       np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(height - y0) // dy), -(-(width - x0) // dx)
            if ph <= 0 or pw <= 0:
                continue
            prow = (pw * bits + 7) // 8
            raw = _unfilter(data[pos:], ph, prow, bpp, path)
            pos += ph * (prow + 1)
            arr[y0::dy, x0::dx] = _samples(raw, ph, pw, depth, channels)
    if ctype == 3:
        if palette is None or int(arr.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        return palette[arr[..., 0]]
    return arr[..., 0] if channels == 1 else arr


def write_png(path, arr):
    """Write a (H, W) or (H, W, C) uint8 / uint16 array as PNG: C = 1
    gray, 2 gray + alpha, 3 RGB, 4 RGBA; each row's filter chosen as
    libpng chooses it (`_filter_rows`)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"PNG needs (H, W) or (H, W, 1..4), got {arr.shape}")
    height, width, channels = arr.shape
    depth = 8 * arr.dtype.itemsize
    samples = arr.astype(">u2" if depth == 16 else np.uint8).reshape(height, -1)
    rows = _filter_rows(samples.view(np.uint8), channels * depth // 8)

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth,
                       _PNG_COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


# ----------------------------------------------------------------- PGM/PPM

def write_pgm(path, arr):
    """Write a (H, W) array as binary 8-bit PGM (P5), or (H, W, 3) as PPM
    (P6)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 3:
        magic = b"P6"
    elif arr.ndim == 2:
        magic = b"P5"
    else:
        raise ValueError(f"PGM/PPM needs (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + f"\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def _read_pnm(path, wide):
    """A binary PGM (P5) -> (H, W) or PPM (P6) -> (H, W, 3) array of its
    samples, uint8 or (maxval > 255, `wide` only) uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"P5", b"P6"):
        raise _unsupported(path, "not a binary PGM/PPM")
    # header: magic, width, height, maxval, with comments
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval > 255 and not wide:
        raise _unsupported(path, "16-bit PGM/PPM is not supported by read_pgm "
                           "(read_image reads it)")
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PGM/PPM maxval {maxval} is out of range")
    channels = 3 if data[:2] == b"P6" else 1
    sample = np.dtype(">u2" if maxval > 255 else np.uint8)
    if len(data) - pos < w * h * channels * sample.itemsize:
        raise ValueError(f"{path}: PGM/PPM data is truncated")
    arr = np.frombuffer(data, dtype=sample, count=w * h * channels,
                        offset=pos)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return arr.reshape(shape).astype(sample.newbyteorder("="))


def read_pgm(path, dtype=np.float64):
    """Read a binary 8-bit PGM (P5) -> (H, W), or PPM (P6) -> (H, W, 3),
    float array.  16-bit files raise, as the JAX package's `read_pgm`
    does; `read_image` reads them."""
    return _read_pnm(path, wide=False).astype(dtype)


# --------------------------------------------------------------------- PFM

def read_pfm(path, dtype=np.float64):
    """Read a PFM (portable float map) -> (H, W) or (H, W, 3) array.

    'PF' (colour) / 'Pf' (gray) header, width height, scale whose sign
    encodes endianness (negative = little-endian), then float32 rows
    stored BOTTOM-UP (the reference's iio PFM path)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline().split()
        while dims and dims[0].startswith(b"#"):
            dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        channels = 3 if magic == b"PF" else 1
        data = np.frombuffer(f.read(4 * w * h * channels),
                             dtype=endian + "f4")
    if data.size != w * h * channels:
        raise ValueError(f"{path}: truncated PFM data")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return data.reshape(shape)[::-1].astype(dtype)


def write_pfm(path, arr, scale=-1.0):
    """Write a (H, W) or (H, W, 3) float array as little-endian PFM."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        magic = b"Pf"
    elif arr.ndim == 3 and arr.shape[2] == 3:
        magic = b"PF"
    else:
        raise ValueError(f"PFM needs (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale:g}\n".encode())
        f.write(arr[::-1].astype("<f4").tobytes())
