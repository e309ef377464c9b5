"""The port's native runtime library (``native.py``, ``csrc/rtnative.c``)
against its Python paths and the JAX package's.

The library is built with the host C compiler on first use; these tests
skip only when no C compiler exists.  Checks: ``png_unfilter`` equals
the port's ``pngio._unfilter_py`` and the JAX package's on seeded random
scanlines of every filter type 0-4 at 1, 2, 3, 4, 6 and 8 bytes a pixel
(the port's encoder writes filter 0 only, so the streams are built here);
``read_png`` on such a PNG gives the same image with and without the
library, and the JAX package's ``read_png`` with its native path off;
``perlin_grid_yoff`` equals the loop of the port's ``Perlin.sample`` and of
the JAX package's bit for bit; ``z_order_batch`` equals the port's
``z_order_f32bits_np``, which equals the JAX package's; and without the
library every entry returns ``None`` and ``read_png`` takes the Python
path.
"""

import math
import struct
import zlib

import numpy as np
import pytest

from raytracer_tpu import native as jnative
from raytracer_tpu import pngio as jpngio
from raytracer_tpu import raymath as jrm
from raytracer_tpu.perlin import Perlin as JPerlin

from raytracer_tpu_torch import native, pngio
from raytracer_tpu_torch import raymath as rm
from raytracer_tpu_torch.perlin import Perlin

# bytes a pixel -> (PNG colour type, bit depth) with that pixel size
_FORMATS = {1: (0, 8), 2: (4, 8), 3: (2, 8), 4: (6, 8), 6: (2, 16),
            8: (6, 16)}


@pytest.fixture(scope="module", autouse=True)
def built():
    if native._compiler() is None:
        pytest.skip("no C compiler ($CC, cc, gcc) on this machine")
    assert native.available(), native.build_log()


def filtered_stream(height, width, bpp, seed):
    """Random filtered scanlines: each row a filter byte (0-4, every type
    at least once when height >= 5) and ``width * bpp`` random bytes."""
    rng = np.random.default_rng(seed)
    ftypes = np.arange(height) % 5
    rng.shuffle(ftypes)
    rows = rng.integers(0, 256, (height, width * bpp), dtype=np.uint8)
    return b"".join(bytes([int(f)]) + r.tobytes()
                    for f, r in zip(ftypes, rows))


def png_bytes(raw, height, width, bpp):
    """A PNG file of the filtered stream ``raw`` (one IDAT chunk)."""
    colortype, depth = _FORMATS[bpp]

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, colortype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("bpp", sorted(_FORMATS))
def test_png_unfilter_matches_python(bpp):
    for height, width, seed in ((10, 7, bpp), (25, 33, 100 + bpp),
                                (5, 1, 200 + bpp)):
        raw = filtered_stream(height, width, bpp, seed)
        got = native.png_unfilter(raw, height, width * bpp, bpp)
        assert got is not None and got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, pngio._unfilter_py(raw, height, width * bpp, bpp))
        np.testing.assert_array_equal(
            got, jpngio._unfilter_py(raw, height, width * bpp, bpp))


@pytest.mark.parametrize("bpp", sorted(_FORMATS))
def test_read_png_same_with_and_without_library(bpp, tmp_path, monkeypatch):
    height, width = 20, 13
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(png_bytes(filtered_stream(height, width, bpp, 7 * bpp),
                           height, width, bpp))
    img = pngio.read_png(path)
    assert img.shape == (height, width, 4) and img.dtype == np.uint8
    monkeypatch.setattr(native, "png_unfilter", lambda *a: None)
    np.testing.assert_array_equal(img, pngio.read_png(path))
    monkeypatch.setattr(jnative, "png_unfilter", lambda *a, **k: None)
    np.testing.assert_array_equal(img, jpngio.read_png(path))


def test_bad_input_falls_back(tmp_path):
    raw = bytearray(filtered_stream(6, 4, 4, 0))
    assert native.png_unfilter(bytes(raw[:-1]), 6, 16, 4) is None  # short
    raw[0] = 9  # an unknown filter type
    assert native.png_unfilter(bytes(raw), 6, 16, 4) is None
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as fh:
        fh.write(png_bytes(bytes(raw), 6, 4, 4))
    with pytest.raises(ValueError, match="bad PNG filter type 9"):
        pngio.read_png(path)


def perlin_loop(p, amp, grid):
    """``Perlin.sample``'s loop over the grid, as the world builder runs it
    when the library is absent."""
    f32 = np.float32
    return np.array(
        [math.floor(f32(0.5) * (p.sample(f32(i), f32(j), f32(0.0))
                                + f32(amp))) + 1
         for i in range(grid) for j in range(grid)], dtype=np.float32)


def test_perlin_grid_matches_python():
    for seed, n, amp, period, grid in ((42, 2, 4.0, 8.0, 8),
                                       (7, 64, 9.0, 32.0, 24)):
        p, jp = Perlin(seed, n), JPerlin(seed, n)
        for q in (p, jp):
            q.set_amplitude(amp)
            q.set_period(period)
        np.testing.assert_array_equal(p.sample_vecs, jp.sample_vecs)
        np.testing.assert_array_equal(np.asarray(p.permutation),
                                      np.asarray(jp.permutation))
        out = native.perlin_grid_yoff(p.sample_vecs, p.permutation, amp,
                                      period, grid)
        np.testing.assert_array_equal(out, perlin_loop(p, amp, grid))
        np.testing.assert_array_equal(out, perlin_loop(jp, amp, grid))
    with pytest.raises(ValueError):
        native.perlin_grid_yoff(p.sample_vecs, p.permutation[:-1], amp,
                                period, grid)


def test_z_order_matches_numpy_and_jax():
    for pts in (np.random.RandomState(3).randn(256, 3).astype(np.float32),
                np.array([[1.5, -2.25, 0.75], [0.0, 3.0, -1.0]], np.float32)):
        zn = native.z_order_batch(pts)
        assert zn.dtype == np.uint64
        np.testing.assert_array_equal(zn, rm.z_order_f32bits_np(pts))
        np.testing.assert_array_equal(zn, jrm.z_order_f32bits_np(pts))


def test_library_absent_returns_none(tmp_path, monkeypatch):
    """The contract without the library: every entry returns None and the
    callers take their Python paths."""
    raw = filtered_stream(10, 5, 3, 1)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(png_bytes(raw, 10, 5, 3))
    with_lib = pngio.read_png(path)
    monkeypatch.setattr(native, "_state", {"lib": None,
                                           "log": "no C compiler found"})
    assert not native.available()
    assert native.build_log() == "no C compiler found"
    assert native.png_unfilter(raw, 10, 15, 3) is None
    assert native.perlin_grid_yoff(np.zeros((2, 3), np.float32), [0, 1],
                                   1.0, 1.0, 2) is None
    assert native.z_order_batch(np.zeros((2, 3), np.float32)) is None
    np.testing.assert_array_equal(pngio.read_png(path), with_lib)


def test_library_is_built_in_the_package():
    path = native.library_path()
    assert path.parent == native.PACKAGE_DIR / "_build" and path.exists()
    assert path.name.startswith("librtnative_")
