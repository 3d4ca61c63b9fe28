"""The port's CLIs and its image and flow IO against the JAX package's
and the reference binary's goldens.

Each CLI's `main(argv, device="cpu")` runs on the goldens' inputs
written as PFM (float, so nothing is rounded), and its `.flo` is held
against the golden flow and against the port's direct solver call.  The
text a CLI prints (usage, clamp warnings, parameter headers) is held
against the JAX CLI's with both solvers replaced by a stub, so the
comparison costs no JAX solve.  The PNG codec (zlib and struct, no
imageio) is held against imageio on files written by imageio, PIL and by
hand with each of the five scanline filters, and its writer's choice of
filter against libpng's rule.
"""

import struct
import zlib
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest
import torch
from PIL import Image

import tpuflow.cli.brox_spatial as jax_brox_cli
import tpuflow.cli.horn_schunck_classic as jax_classic_cli
import tpuflow.cli.horn_schunck_pyramidal as jax_hs_cli
import tpuflow.cli.robust_expo_methods as jax_robust_cli
import tpuflow.cli.tvl1flow as jax_tvl1_cli
import tpuflow.io.flo as jax_flo
import tpuflow_torch.cli.brox_spatial as brox_cli
import tpuflow_torch.cli.horn_schunck_classic as classic_cli
import tpuflow_torch.cli.horn_schunck_pyramidal as hs_cli
import tpuflow_torch.cli.robust_expo_methods as robust_cli
import tpuflow_torch.cli.tvl1flow as tvl1_cli
from tpuflow_torch import (brox_spatial, hs_classic, hs_pyramidal,
                           robust_expo, tvl1_multiscale)
from tpuflow_torch.io import read_flow, read_image, write_flow, write_pfm
from tpuflow_torch.io.image import read_png, write_image, write_png

torch.set_num_threads(2)

GOLDENS = Path(__file__).resolve().parent / "goldens"


def _epe(f, ref):
    return float(np.mean(np.hypot(np.asarray(f[0]) - np.asarray(ref[0]),
                                  np.asarray(f[1]) - np.asarray(ref[1]))))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{name: (path0, path1, numpy pair, golden npz)}: the goldens' pairs
    as PFM (robust-expo's colour pair as 3-channel PFM)."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, k0, k1 in (("solvers", "I0", "I1"), ("brox", "I0", "I1"),
                         ("robust_expo", "I0", "I1"),
                         ("robust_expo", "rgb0", "rgb1")):
        g = dict(np.load(f"{GOLDENS}/{name}.npz"))
        key = f"{name}_{k0}"
        paths = [str(d / f"{key}_{i}.pfm") for i in range(2)]
        for p, k in zip(paths, (k0, k1)):
            write_pfm(p, g[k])
        out[key] = (*paths, (g[k0].astype(np.float32), g[k1].astype(np.float32)), g)
    return out


def _planes(a):
    return np.moveaxis(a, -1, 0) if a.ndim == 3 else a


# (module, input key, extra leading args, golden flow, EPE bound, direct call)
CASES = {
    "tvl1flow": (tvl1_cli, "solvers_I0", (), "tvl1_multi", 0.05,
                 lambda a, b: tvl1_multiscale(a, b, device="cpu")),
    "horn_schunck_pyramidal": (hs_cli, "solvers_I0", (), "hs_pyramidal", 0.05,
                               lambda a, b: hs_pyramidal(a, b, device="cpu")),
    "horn_schunck_classic": (classic_cli, "solvers_I0", ("100", "20"),
                             "hs_classic", 1e-4,
                             lambda a, b: hs_classic(a, b, 100, 20.0,
                                                     device="cpu")),
    "brox_spatial": (brox_cli, "brox_I0", (), "spatial_s3", 0.05,
                     lambda a, b: brox_spatial(a, b, device="cpu")),
    "robust_expo_methods": (robust_cli, "robust_expo_I0", (), "gray_m1", 0.05,
                            lambda a, b: robust_expo(a, b, device="cpu")),
    "robust_expo_methods_rgb": (robust_cli, "robust_expo_rgb0", (), "rgb_m1",
                                0.05, lambda a, b: robust_expo(
                                    _planes(a), _planes(b), device="cpu")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_matches_golden_and_direct_call(name, inputs, tmp_path, capsys):
    module, key, lead, golden, bound, direct = CASES[name]
    p0, p1, pair, g = inputs[key]
    out = str(tmp_path / ("f.uv" if name == "horn_schunck_classic" else "f.flo"))
    argv = [*lead, p0, p1, out] if lead else [p0, p1, out]
    assert module.main(argv, device="cpu") == 0
    flow = read_flow(out)
    assert flow[0].shape == pair[0].shape[:2] and flow[0].dtype == np.float32
    assert _epe(flow, (g[f"{golden}_u"], g[f"{golden}_v"])) <= bound
    u, v = direct(*pair)
    assert _epe(flow, (u.numpy(), v.numpy())) <= 1e-6
    stdout = capsys.readouterr().out
    # robust-expo prints its parameter header whether or not verbose is set
    assert ("ncores:0 method_type:1" in stdout) == name.startswith("robust")


def _stub(*images, **kw):
    """A solver that prints nothing and returns zero flow of the images'
    (H, W)."""
    shape = np.shape(images[0])[-2:]
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


# (port CLI, JAX CLI, solver name in both, argv after the input paths)
TEXT_CASES = {
    "tvl1flow": (tvl1_cli, jax_tvl1_cli, "tvl1_multiscale",
                 ["o.flo", "2", "0.5", "-1", "0", "-3", "1.5", "0", "-1", "1"]),
    "horn_schunck_pyramidal": (hs_cli, jax_hs_cli, "hs_pyramidal",
                               ["o.flo", "0", "-7", "0", "2", "-1", "0", "0", "1"]),
    "horn_schunck_classic": (classic_cli, jax_classic_cli, "hs_classic_jit", []),
    "brox_spatial": (brox_cli, jax_brox_cli, "brox_spatial",
                     ["o.flo", "1", "-50", "-1", "0", "7", "0", "0", "-2", "1"]),
    "robust_expo_methods": (robust_cli, jax_robust_cli, "robust_expo",
                            ["o.flo", "1", "9", "-1", "-2", "-3", "0", "2", "-1",
                             "0", "0", "1"]),
}


@pytest.mark.parametrize("name", sorted(TEXT_CASES))
def test_cli_text_matches_jax(name, inputs, tmp_path, monkeypatch, capsys):
    """Usage, clamp warnings and headers are the JAX CLI's, character for
    character, for invalid parameters with verbose on."""
    port, jax_cli, solver, rest = TEXT_CASES[name]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_cli, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(jax_cli, solver, _stub)
    monkeypatch.setattr(port, "hs_classic" if solver == "hs_classic_jit"
                        else solver, _stub)
    p0, p1 = inputs["solvers_I0"][:2]
    argv = ["100", "20", p0, p1, "o.flo"] if not rest else [p0, p1, *rest]
    texts = []
    for cli in (jax_cli, port):
        assert cli.main(argv) == 0  # the stub needs no device
        assert read_flow("o.flo")[0].shape == (64, 96)
        assert cli.main(argv[:1]) == 1  # usage
        texts.append(capsys.readouterr())
    (jout, jerr), (out, err) = texts
    assert (out, err) == (jout, jerr)
    assert "sage" in err
    if rest:
        assert "warning:" in err


def test_classic_cli_on_png_matches_jax_cli(tmp_path, monkeypatch):
    """End to end through the image codecs: the JAX CLI (imageio, XLA)
    and the port's (its own PNG codec, K6's plain version) read the
    same 8-bit PNG pair and give the same flow."""
    g = np.load(f"{GOLDENS}/solvers.npz")
    paths = [str(tmp_path / f"{k}.png") for k in ("I0", "I1")]
    for p, k in zip(paths, ("I0", "I1")):
        iio.imwrite(p, np.clip(np.round(g[k]), 0, 255).astype(np.uint8))
    monkeypatch.setattr(jax_classic_cli, "enable_persistent_cache", lambda: None)
    assert jax_classic_cli.main(["50", "10", *paths, str(tmp_path / "j.flo")]) == 0
    assert classic_cli.main(["50", "10", *paths, str(tmp_path / "p.flo")],
                            device="cpu") == 0
    ju, jv = jax_flo.read_flo(str(tmp_path / "j.flo"))
    u, v = read_flow(str(tmp_path / "p.flo"))
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-5)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-5)


def test_cli_needs_a_card_unless_cpu(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p0, p1 = inputs["solvers_I0"][:2]
    for module, lead in ((tvl1_cli, ()), (classic_cli, ("10", "7"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main([*lead, p0, p1, str(tmp_path / "o.flo")])


def test_flow_files_match_jax_codec(tmp_path):
    rng = np.random.default_rng(0)
    u, v = (rng.standard_normal((12, 16)).astype(np.float32) for _ in range(2))
    for ext in ("flo", "uv"):
        ours, theirs = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
        write_flow(ours, u, v)
        jax_flo.write_flow(theirs, u, v)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        ru, rv = read_flow(theirs)
        assert np.array_equal(ru, u) and np.array_equal(rv, v)


# ------------------------------------------------------------------ PNG

def _image(kind, rng):
    shape = {"gray": (23, 37), "rgb": (23, 37, 3), "rgba": (23, 37, 4),
             "gray_alpha": (23, 37, 2), "gray16": (23, 37)}[kind]
    dtype = np.uint16 if kind == "gray16" else np.uint8
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray_alpha", "gray16"])
def test_png_round_trip_against_imageio(kind, tmp_path):
    arr = _image(kind, np.random.default_rng(len(kind)))
    theirs, ours = str(tmp_path / "i.png"), str(tmp_path / "p.png")
    if kind == "gray_alpha":
        Image.fromarray(arr, mode="LA").save(theirs)
    else:
        iio.imwrite(theirs, arr)
    got = read_png(theirs)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    write_png(ours, arr)
    assert np.array_equal(iio.imread(ours), arr)
    np.testing.assert_array_equal(
        read_image(theirs, gray=False), np.asarray(iio.imread(theirs), np.float64))
    # gray=True averages every channel, alpha included
    want = arr.astype(np.float64)
    np.testing.assert_allclose(read_image(ours), want.mean(axis=2) if want.ndim == 3
                               else want)


def test_png_palette_and_packed_depths(tmp_path):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 4, (9, 13)).astype(np.uint8)
    for bits in (2, 8):
        p = Image.fromarray(idx, mode="P")
        p.putpalette([10, 20, 30, 40, 50, 60, 70, 80, 90, 200, 210, 220])
        path = str(tmp_path / f"p{bits}.png")
        p.save(path, bits=bits)
        assert np.array_equal(read_png(path), iio.imread(path))  # palette -> RGB
    path = str(tmp_path / "one.png")
    Image.fromarray(idx % 2 == 1).save(path)  # 1-bit gray
    np.testing.assert_array_equal(read_image(path, gray=False),
                                  np.asarray(iio.imread(path), np.float64))


def _forward_filter(cur, prev, bpp, ftype):
    """Filter type `ftype` of one scanline `cur` (int64 bytes) below
    `prev` (PNG spec 9.2, forward form)."""
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    cc = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (a + prev) // 2
    else:
        p = a + prev - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
    return (cur - pred) % 256


def _png_bytes(arr, filters, interlace=0):
    """A PNG of uint8/uint16 `arr` whose row r uses filter
    filters[r % len(filters)]."""
    arr = arr if arr.ndim == 3 else arr[:, :, None]
    h, w, c = arr.shape
    depth = 8 * arr.dtype.itemsize
    raw = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    bpp = c * depth // 8
    prev = np.zeros(raw.shape[1], np.int64)
    body = bytearray()
    for r in range(h):
        cur = raw[r].astype(np.int64)
        ftype = filters[r % len(filters)]
        body += bytes([ftype]) + _forward_filter(cur, prev, bpp, ftype).astype(
            np.uint8).tobytes()
        prev = cur

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray", "rgb", "gray16", "rgba16"])
def test_png_all_five_filters(kind, tmp_path):
    """Every row filter, Paeth's ties included (a smooth image makes
    many), in 8- and 16-bit samples, against imageio and the source."""
    yy, xx = np.mgrid[0:20, 0:31]
    base = 128 + 60 * np.sin(xx / 4.0) * np.cos(yy / 3.0)
    if kind.endswith("16"):
        base = base * 257
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    chans = {"gray": 1, "rgb": 3, "gray16": 1, "rgba16": 4}[kind]
    arr = np.stack([np.roll(base, k, axis=1) for k in range(chans)], -1)
    arr = np.round(arr).astype(dtype)
    arr = arr[..., 0] if chans == 1 else arr
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(arr, [0, 1, 2, 3, 4, 4, 3, 1]))
    got = read_png(str(path))
    assert np.array_equal(got, arr)
    if kind != "rgba16":  # PIL reads 16-bit colour as 8-bit
        assert np.array_equal(got, iio.imread(str(path)))


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba16"])
def test_png_random_filters_on_noise(kind, tmp_path):
    """Rows of noise, each with a filter drawn at random, at every pixel
    width from 1 to 8 bytes: the decoder's diagonal steps against the
    source."""
    rng = np.random.default_rng(7)
    shape = {"gray": (19, 1), "gray_alpha": (1, 23), "rgb": (31, 17),
             "rgba16": (13, 29)}[kind]
    chans = {"gray": 1, "gray_alpha": 2, "rgb": 3, "rgba16": 4}[kind]
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    arr = rng.integers(0, np.iinfo(dtype).max + 1, (*shape, chans)).astype(dtype)
    arr = arr[..., 0] if chans == 1 else arr
    path = tmp_path / "n.png"
    path.write_bytes(_png_bytes(arr, rng.integers(0, 5, shape[0]).tolist()))
    assert np.array_equal(read_png(str(path)), arr)


def test_png_writer_filters_rows_as_libpng(tmp_path):
    """Each row the writer stores carries the filter whose bytes, taken
    as signed, sum to the least absolute value, and imageio reads the
    file back as written."""
    yy, xx = np.mgrid[0:24, 0:40]
    rng = np.random.default_rng(2)
    im = 128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 4.0) + rng.normal(0, 2, xx.shape)
    arr = np.clip(np.round(np.stack([im, 255 - im, 0.5 * im], -1)), 0, 255).astype(np.uint8)
    arr[:3] = 7  # flat rows, where None or Up wins
    path = str(tmp_path / "w.png")
    write_png(path, arr)
    assert np.array_equal(iio.imread(path), arr) and np.array_equal(read_png(path), arr)
    data = open(path, "rb").read()
    idat = zlib.decompress(data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 8])
    rows = np.frombuffer(idat, np.uint8).reshape(24, 40 * 3 + 1)
    raw = arr.reshape(24, -1).astype(np.int64)
    used = set()
    for r in range(24):
        prev = raw[r - 1] if r else np.zeros_like(raw[0])
        cand = [_forward_filter(raw[r], prev, 3, f) for f in range(5)]
        cost = [int(np.minimum(c, 256 - c).sum()) for c in cand]
        assert rows[r, 0] == int(np.argmin(cost))
        assert np.array_equal(rows[r, 1:], cand[rows[r, 0]])
        used.add(int(rows[r, 0]))
    assert len(used) >= 2 and used & {3, 4}


def test_png_and_formats_refused(tmp_path):
    arr = np.zeros((4, 5), np.uint8)
    path = tmp_path / "interlaced.png"
    # PNG defines interlace methods 0 (none) and 1 (Adam7) only
    path.write_bytes(_png_bytes(arr, [0], interlace=2))
    with pytest.raises(ValueError, match=r"interlace method 2.*PNG \(\.png\)"):
        read_image(str(path))
    with pytest.raises(ValueError, match=r"\.jpg.*PFM \(\.pfm\)"):
        read_image(str(tmp_path / "a.jpg"))
    bad = bytearray(_png_bytes(arr, [0]))
    bad[-20] ^= 1  # inside IDAT: its CRC no longer holds
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(path))


def test_pgm_ppm_pfm_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (7, 9)).astype(np.uint8)
    rgb = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    for name, arr in (("g.pgm", gray), ("c.ppm", rgb)):
        write_image(str(tmp_path / name), arr)
        np.testing.assert_array_equal(read_image(str(tmp_path / name), gray=False), arr)
        assert np.array_equal(iio.imread(str(tmp_path / name)), arr)
    f = rng.standard_normal((7, 9, 3)).astype(np.float32)
    write_image(str(tmp_path / "f.pfm"), f)
    np.testing.assert_array_equal(read_image(str(tmp_path / "f.pfm"), gray=False), f)
    from tpuflow.io.image import read_pfm as jax_read_pfm
    np.testing.assert_array_equal(jax_read_pfm(str(tmp_path / "f.pfm")), f)
