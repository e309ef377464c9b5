"""Pure-Python MT19937 matching ``std::mt19937`` plus the libstdc++ distribution
adapters the reference uses for procedural generation.

A copy of ``raytracer_tpu/mt19937.py`` (that package's ``__init__`` imports
JAX, so the port cannot import it from there).

The reference seeds ``std::mt19937`` and draws through
``std::uniform_real_distribution<float>`` / ``std::uniform_int_distribution<unsigned>``
(reference: src/procedural/perlin.cu:83-103).  Reproducing the exact terrain of the
``world*.json`` fixtures requires reproducing those streams bit-for-bit:

* ``std::mt19937`` seeding is the classic ``init_genrand`` recurrence
  (x0 = seed; x_i = 1812433253 * (x_{i-1} ^ (x_{i-1} >> 30)) + i).
* ``uniform_real_distribution<float>`` on [0,1) is libstdc++'s
  ``generate_canonical<float, 24>``: one 32-bit draw, ``float(u32) / 2^32`` computed in
  float32, clamped below 1.0.
* ``uniform_int_distribution<unsigned>`` over the full range returns the raw draw.

A subtlety worth documenting: the reference builds its callables with
``std::bind(dist{}, generator)``, which copies the generator *by value*.  Both the
real-valued stream and the later integer stream therefore start from the same freshly
seeded state (reference: src/procedural/perlin.cu:84-96).  Callers that need that
behavior should create two independent ``MT19937`` objects with the same seed.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF

# Largest float32 strictly below 1.0 (nextafter(1, 0)).
_ONE_MINUS_EPS = np.nextafter(np.float32(1.0), np.float32(0.0))


class MT19937:
    """Bit-faithful ``std::mt19937`` (32-bit Mersenne Twister)."""

    def __init__(self, seed: int = 5489):
        self.mt = [0] * _N
        self.mti = _N
        self.seed(seed)

    def seed(self, s: int) -> None:
        self.mt[0] = s & _MASK32
        for i in range(1, _N):
            prev = self.mt[i - 1]
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & _MASK32
        self.mti = _N

    def _generate(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            nxt = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                nxt ^= _MATRIX_A
            mt[i] = nxt
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= _N:
            self._generate()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32

    # ---- libstdc++ distribution adapters -------------------------------------

    def uniform_real_f32(self) -> np.float32:
        """``uniform_real_distribution<float>{}(gen)`` on [0, 1): one raw draw,
        ``float(u32) / 2^32`` in float32 arithmetic, clamped strictly below 1."""
        u = self.next_u32()
        val = np.float32(np.float32(u) / np.float32(4294967296.0))
        if val >= np.float32(1.0):
            val = _ONE_MINUS_EPS
        return val

    def uniform_uint(self) -> int:
        """``uniform_int_distribution<unsigned>{}(gen)`` over the full 32-bit range:
        the distribution range equals the generator range, so the raw draw passes
        through unchanged."""
        return self.next_u32()
