"""Optical-flow file codecs: Middlebury `.flo` and JUV `.uv`.

A copy of tpuflow/io/flo.py (numpy only), so that the port reads and
writes the same files without importing the JAX package.

.flo layout (observed at reference src/iio.cpp:2233-2255 and the
writer dispatch at src/iio.cpp:3664-3675): 4-byte float magic
202021.25 (the bytes spell "PIEH"), int32 width, int32 height, then
h*w*2 float32 samples interleaved (u, v) in row-major order.  The
reference always downcasts to float32 on write
(src/tvl1flow_main.cpp:209-214).

.uv (JUV) layout (reference reader src/iio.cpp:2259-2292, writer
src/iio.cpp:2729-2751, dispatched for 2-channel float images whose
filename ends in ".uv", src/iio.cpp:3665-3670): a 255-byte header —
the text `#UV {\n dimx %d dimy %d\n}\n` plus its terminating NUL,
space-padded to 255 — followed by the full u plane then the full v
plane as float32 (PLANAR, unlike .flo's interleaving).
"""

import struct

import numpy as np

FLO_MAGIC = 202021.25
FLO_TAG = struct.pack("<f", FLO_MAGIC)  # b'PIEH'


def read_flo(path):
    """Read a .flo file -> (u, v) float32 arrays of shape (H, W)."""
    with open(path, "rb") as f:
        tag = f.read(4)
        if tag != FLO_TAG:
            raise ValueError(f"{path}: bad .flo magic {tag!r} (want {FLO_TAG!r})")
        w, h = struct.unpack("<ii", f.read(8))
        if not (0 < w < 100000 and 0 < h < 100000):
            raise ValueError(f"{path}: implausible size {w}x{h}")
        data = np.frombuffer(f.read(w * h * 2 * 4), dtype="<f4")
    if data.size != w * h * 2:
        raise ValueError(f"{path}: truncated data")
    uv = data.reshape(h, w, 2)
    return uv[..., 0].copy(), uv[..., 1].copy()


def write_flo(path, u, v):
    """Write flow components u, v (H, W) as a float32 .flo file."""
    u = np.asarray(u, dtype="<f4")
    v = np.asarray(v, dtype="<f4")
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"u/v must be matching 2D arrays, got {u.shape} {v.shape}")
    h, w = u.shape
    uv = np.stack([u, v], axis=-1)
    with open(path, "wb") as f:
        f.write(FLO_TAG)
        f.write(struct.pack("<ii", w, h))
        f.write(uv.tobytes())


JUV_HEADER_LEN = 255  # reference src/iio.cpp:2735 (buf[255])


def read_juv(path):
    """Read a JUV .uv file -> (u, v) float32 arrays of shape (H, W)."""
    import re

    with open(path, "rb") as f:
        head = f.read(JUV_HEADER_LEN)
        m = re.match(rb"#UV \{\n dimx (\d+) dimy (\d+)\n\}\n", head)
        if not m:
            raise ValueError(f"{path}: bad JUV header {head[:32]!r}")
        w, h = int(m.group(1)), int(m.group(2))
        u = np.frombuffer(f.read(w * h * 4), dtype="<f4")
        v = np.frombuffer(f.read(w * h * 4), dtype="<f4")
    if u.size != w * h or v.size != w * h:
        raise ValueError(f"{path}: truncated data")
    return u.reshape(h, w).copy(), v.reshape(h, w).copy()


def write_juv(path, u, v):
    """Write flow components u, v (H, W) as a JUV .uv file
    (byte-compatible with reference iio_save_image_as_juv,
    src/iio.cpp:2729-2751: NUL-terminated header space-padded to 255,
    planar u then v float32)."""
    u = np.asarray(u, dtype="<f4")
    v = np.asarray(v, dtype="<f4")
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"u/v must be matching 2D arrays, got {u.shape} {v.shape}")
    h, w = u.shape
    text = f"#UV {{\n dimx {w} dimy {h}\n}}\n".encode() + b"\0"
    head = text + b" " * (JUV_HEADER_LEN - len(text))
    with open(path, "wb") as f:
        f.write(head)
        f.write(u.tobytes())
        f.write(v.tobytes())


def write_flow(path, u, v):
    """Extension-dispatched flow writer replicating the reference's
    iio_save_image_default rule (src/iio.cpp:3655-3675): `.uv` ->
    JUV, anything else -> .flo."""
    if str(path).endswith(".uv"):
        write_juv(path, u, v)
    else:
        write_flo(path, u, v)


def read_flow(path):
    """Extension/magic-dispatched flow reader: PIEH magic -> .flo,
    `#UV` header -> JUV."""
    with open(path, "rb") as f:
        head4 = f.read(4)
    if head4 == FLO_TAG:
        return read_flo(path)
    if head4 == b"#UV ":
        return read_juv(path)
    raise ValueError(f"{path}: unrecognized flow file (magic {head4!r})")
