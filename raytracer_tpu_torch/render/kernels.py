"""Build and bind the CUDA kernels of ``csrc/``.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, ``_build/librt_kernels_<hash>.so``
(the hash covers the sources and the flags, so an edit rebuilds), which is
then loaded with ctypes.  Nothing here runs at import time: the CPU tests
import every module, and this machine may have no ``nvcc`` at all.

Flags: no fast math, and ``-fmad=false`` so that every operation rounds
once, like the separately rounded torch ops of the plain versions in
``cuda_engine.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, printed to stderr
]


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librt_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet.  Returns ``(path,
    compiler log)``; the log is empty when the library already existed.
    Raises with nvcc's stderr when compilation fails."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    return path, res.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        # K1-K3 (bvh_kernels.cu)
        "rt_bvh_cast": [vp, vp, ci, vp, vp, ci, vp, vp, vp,
                        vp, vp, vp, vp, vp, ci, vp],
        "rt_bvh_occlude2": [vp, vp, vp, vp, vp, vp, ci, vp, vp, ci,
                            vp, vp, vp, vp, vp, ci, vp],
        "rt_bvh_occlude": [vp, vp, vp, ci, vp, vp, ci, vp, vp, vp,
                           vp, ci, vp],
        # K4, K5 (cull_kernels.cu)
        "rt_cull_cast": [vp, vp, ci, vp, vp, ci, ci, vp, vp, vp,
                         vp, vp, vp, vp, vp, ci, vp],
        "rt_cull_occlude": [vp, vp, vp, ci, vp, vp, ci, ci, vp, vp, ci,
                            vp, vp, ci, vp],
        # K6 (mxu_kernel.cu)
        "rt_mxu_cast": [vp, vp, ci, vp, ci, ci, vp, vp, ci, ci,
                        vp, vp, vp, vp, vp, vp, vp, ci, vp],
        "rt_mxu_workers": [ci],
        "rt_mxu_split": [],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ci
    return lib


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
