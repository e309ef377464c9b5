"""ctypes bindings of the port's native runtime library (``csrc/rtnative.c``).

Counterpart of ``raytracer_tpu/native.py``.  On first use, :func:`load`
compiles ``csrc/rtnative.c`` with the host C compiler (``$CC``, else
``cc`` or ``gcc``) into ``_build/librtnative_<hash>.so``, the hash covering
the source and the flags, so an edit rebuilds; a concurrent builder's copy
is replaced atomically.  Flags: ``-O3 -fPIC -shared -ffp-contract=off
-lm``, with no ``-march=native`` and no fast math: a contracted FMA in the
Perlin loop would break its bit-equality with ``perlin.Perlin.sample``.

Every entry returns ``None`` when the library cannot be built or loaded
(the callers then take their Python paths); :func:`build_log` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "rtnative.c"
BUILD_DIR = PACKAGE_DIR / "_build"
CFLAGS = ["-O3", "-fPIC", "-shared", "-ffp-contract=off"]

_lock = threading.Lock()
_state: dict = {}  # "lib": the CDLL or None once tried, "log": the build log


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librtnative_{h.hexdigest()[:16]}.so"


def _compiler() -> Optional[str]:
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def _build() -> tuple[Optional[Path], str]:
    """Compile the library unless it exists.  Returns ``(path or None,
    log)``."""
    path = library_path()
    if path.exists():
        return path, ""
    cc = _compiler()
    if cc is None:
        return None, "no C compiler found ($CC, cc, gcc)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [cc, *CFLAGS, "-o", str(tmp), str(SOURCE), "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        return None, f"{' '.join(cmd)}: {e}"
    log = f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, log
    os.replace(tmp, path)
    return path, log


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, cl, i32, f32 = (ctypes.c_void_p, ctypes.c_long, ctypes.c_int32,
                        ctypes.c_float)
    lib.rt_png_unfilter.restype = ctypes.c_int
    lib.rt_png_unfilter.argtypes = [vp, vp, cl, cl, cl]
    lib.rt_perlin_grid_yoff.restype = None
    lib.rt_perlin_grid_yoff.argtypes = [vp, vp, i32, f32, f32, i32, vp]
    lib.rt_z_order_batch.restype = None
    lib.rt_z_order_batch.argtypes = [vp, cl, vp]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; ``None`` if it cannot
    be built or loaded (tried once a process)."""
    with _lock:
        if "lib" not in _state:
            path, log = _build()
            lib = None
            if path is not None:
                try:
                    lib = _bind(ctypes.CDLL(str(path)))
                except (OSError, AttributeError) as e:
                    log += f"\nloading {path}: {e}"
            _state.update(lib=lib, log=log)
        return _state["lib"]


def available() -> bool:
    return load() is not None


def build_log() -> str:
    """The compiler's command and output of this process's build (empty
    when the library was already built), or why it failed."""
    load()
    return _state["log"]


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int
                 ) -> Optional[np.ndarray]:
    """Unfilter PNG scanlines (``[height, stride]`` uint8); ``None`` if the
    library is absent, the data is short or a filter type is unknown."""
    lib = load()
    if lib is None:
        return None
    raw_arr = np.frombuffer(raw, dtype=np.uint8)
    if height < 0 or stride < 0 or bpp < 1 or \
            raw_arr.size < height * (stride + 1):
        return None
    out = np.empty((height, stride), dtype=np.uint8)
    rc = lib.rt_png_unfilter(raw_arr.ctypes.data, out.ctypes.data, height,
                             stride, bpp)
    return out if rc == 0 else None


def perlin_grid_yoff(sample_vecs: np.ndarray, permutation, amplitude: float,
                     period: float, grid: int) -> Optional[np.ndarray]:
    """Terrain stack offsets ``floor(0.5 * (sample(i, j, 0) + amplitude)) +
    1`` of a ``grid x grid`` field (``[grid * grid]`` float32); ``None`` if
    the library is absent."""
    lib = load()
    if lib is None:
        return None
    sv = np.ascontiguousarray(sample_vecs, dtype=np.float32)
    perm = np.ascontiguousarray(permutation, dtype=np.int32)
    n = sv.shape[0]
    if sv.shape != (n, 3) or perm.shape != (n,) or n == 0 or \
            perm.min() < 0 or perm.max() >= n or grid < 0:
        raise ValueError(f"sample_vecs {sv.shape} / permutation "
                         f"{perm.shape}: need [n, 3] and a permutation of n")
    out = np.empty(grid * grid, dtype=np.float32)
    lib.rt_perlin_grid_yoff(sv.ctypes.data, perm.ctypes.data, n,
                            float(amplitude), float(period), grid,
                            out.ctypes.data)
    return out


def z_order_batch(centers: np.ndarray) -> Optional[np.ndarray]:
    """:func:`raymath.z_order_f32bits_np` of ``[n, 3]`` centers (uint64
    ``[n]``); ``None`` if the library is absent."""
    lib = load()
    if lib is None:
        return None
    c = np.ascontiguousarray(centers, dtype=np.float32)
    if c.ndim != 2 or c.shape[1] != 3:
        raise ValueError(f"centers {c.shape}: need [n, 3]")
    out = np.empty(c.shape[0], dtype=np.uint64)
    lib.rt_z_order_batch(c.ctypes.data, c.shape[0], out.ctypes.data)
    return out
