"""Seeded 3-D gradient ("Perlin") noise, bit-faithful to the reference generator.

A copy of ``raytracer_tpu/perlin.py`` (numpy only; the JAX package's
``__init__`` imports JAX, so the port cannot import it from there).

Behavior spec (reference: src/procedural/perlin.cu, include/procedural/perlin.h):

* ``n_sample_vecs`` gradient vectors are drawn from a seeded ``std::mt19937``:
  ``theta = acos(2*u - 1)``, ``phi = 2*u*pi``; the gradient is the unit sphere point
  ``(cos(phi) sin(theta), sin(phi) sin(theta), cos(theta))`` re-normalized
  (perlin.cu:89-94).
* A permutation table of size ``n_sample_vecs`` is initialized to the identity and then
  shuffled with ``uniform_int_distribution<unsigned>() % n`` swaps (perlin.cu:96-102).
  Because the reference wraps both distributions with ``std::bind(dist, generator)``
  (which copies the generator by value), the integer stream REUSES the same seeded
  stream from the start rather than continuing after the real-valued draws.  We
  replicate that by using two independently constructed MT19937 instances.
* ``hash(x, y, z)`` chains permutation lookups modulo ``n`` (perlin.cu:13-23).
* ``sample(x, y, z)`` scales inputs by ``n_sample_vecs / period``, computes smoothstep
  weights ``m* = d*d*(3-2d)``, corner weights ``w = dot(grad, normalize(corner_offset))``
  and tri-"lerps" with the reference's **reversed** interpolation
  ``interpolate(a, b, w) = w*a + (1-w)*b`` (perlin.cu:8-10, 59-81) -- i.e. the weight
  multiplies the *low* corner.  This is deliberately preserved, quirk and all, because
  terrain heights feed ``floor()`` and must match exactly.

All arithmetic is done in float32 to mirror the reference's ``float`` math.
"""

from __future__ import annotations

import math

import numpy as np

from .mt19937 import MT19937

f32 = np.float32


def _smoothstep(d: f32) -> f32:
    return f32(d * d * (f32(3.0) - f32(2.0) * d))


class Perlin:
    """Host-side noise generator used by the procedural cube-world builder."""

    def __init__(self, seed: int, n_sample_vecs: int):
        self.n = int(n_sample_vecs)
        self.amplitude = f32(1.0)
        self.period = f32(1.0)

        # The reference's unqualified acos/cos/sin resolve to the double-precision C
        # functions (float args promoted, results narrowed on assignment) — verified
        # by compiling perlin.cu with g++; the float32 roundings below mirror that.
        rng_real = MT19937(seed)
        self.sample_vecs = np.zeros((self.n, 3), dtype=np.float32)
        for i in range(self.n):
            u1 = rng_real.uniform_real_f32()
            theta = f32(math.acos(float(f32(f32(2.0) * u1) - f32(1.0))))
            u2 = rng_real.uniform_real_f32()
            phi = f32(float(f32(f32(2.0) * u2)) * math.pi)
            v = np.array(
                [
                    f32(math.cos(phi) * math.sin(theta)),
                    f32(math.sin(phi) * math.sin(theta)),
                    f32(math.cos(theta)),
                ],
                dtype=np.float32,
            )
            norm = f32(np.sqrt(np.float32(np.dot(v, v))))
            if norm > f32(1e-5):
                v = (f32(1.0) / norm) * v
            else:
                v = np.zeros(3, dtype=np.float32)
            self.sample_vecs[i] = v

        # Fresh copy of the seeded generator (std::bind copies by value).
        rng_int = MT19937(seed)
        perm = list(range(self.n))
        for i in range(self.n):
            j = rng_int.uniform_uint() % self.n
            perm[i], perm[j] = perm[j], perm[i]
        self.permutation = perm

    def set_amplitude(self, a: float) -> None:
        self.amplitude = f32(a)

    def set_period(self, p: float) -> None:
        self.period = f32(p)

    def _hash(self, x: int, y: int, z: int) -> np.ndarray:
        n = self.n
        hx = int(x) % n
        hxy = (self.permutation[hx] + int(y)) % n
        hxyz = (self.permutation[hxy] + int(z)) % n
        return self.sample_vecs[self.permutation[hxyz]]

    def sample(self, x: float, y: float, z: float) -> f32:
        n = self.n
        sx = f32(f32(x) * f32(n) / self.period)
        sy = f32(f32(y) * f32(n) / self.period)
        sz = f32(f32(z) * f32(n) / self.period)

        ix = int(math.floor(sx)) % n
        iy = int(math.floor(sy)) % n
        iz = int(math.floor(sz)) % n
        mx = _smoothstep(f32(sx - f32(math.floor(sx))))
        my = _smoothstep(f32(sy - f32(math.floor(sy))))
        mz = _smoothstep(f32(sz - f32(math.floor(sz))))

        def gen_weight(dx: int, dy: int, dz: int) -> f32:
            cx, cy, cz = ix + dx, iy + dy, iz + dz
            off = np.array([f32(dx) - mx, f32(dy) - my, f32(dz) - mz], dtype=np.float32)
            norm = f32(np.sqrt(np.float32(np.dot(off, off))))
            if norm > f32(1e-5):
                off = (f32(1.0) / norm) * off
            else:
                off = np.zeros(3, dtype=np.float32)
            wv = self._hash(cx, cy, cz)
            return f32(np.float32(np.dot(wv, off)))

        w000 = gen_weight(0, 0, 0)
        w001 = gen_weight(0, 0, 1)
        w010 = gen_weight(0, 1, 0)
        w011 = gen_weight(0, 1, 1)
        w100 = gen_weight(1, 0, 0)
        w101 = gen_weight(1, 0, 1)
        w110 = gen_weight(1, 1, 0)
        w111 = gen_weight(1, 1, 1)

        # Reference's reversed lerp: interpolate(a, b, w) = w*a + (1-w)*b.
        def interp(a: f32, b: f32, w: f32) -> f32:
            return f32(w * a + (f32(1.0) - w) * b)

        x00 = interp(w000, w100, mx)
        x01 = interp(w001, w101, mx)
        x10 = interp(w010, w110, mx)
        x11 = interp(w011, w111, mx)
        xy0 = interp(x00, x10, my)
        xy1 = interp(x01, x11, my)
        xyz = interp(xy0, xy1, mz)
        return f32(self.amplitude * xyz)
