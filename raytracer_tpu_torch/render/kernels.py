"""Build and bind the CUDA kernels of ``csrc/``.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process a source, all started together, and links the objects into one
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
    "-Xcompiler", "-fPIC",
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
    nvcc = find_nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = [proc.communicate()[1] for _, _, proc in jobs]  # wait for all
    for (cmd, _, proc), err in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    tmp = path.with_name(f"{tag}.tmp.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    return path, "".join(logs) + res.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        # K1-K3 and the transmissive march (bvh_kernels.cu)
        "rt_bvh_cast": [vp, vp, ci, vp, vp, ci, vp, vp, vp,
                        vp, vp, vp, vp, vp, ci, vp, ci, vp],
        "rt_bvh_occlude2": [vp, vp, vp, vp, vp, vp, ci, vp, vp, ci,
                            vp, vp, vp, vp, vp, ci, vp],
        "rt_bvh_occlude": [vp, vp, vp, ci, vp, vp, ci, vp, vp, vp,
                           vp, ci, vp],
        "rt_bvh_march": [vp, vp, ci, vp, ctypes.c_float, vp, vp, vp, ci,
                         ci, vp, vp, ci, vp, vp, vp, vp, ci, vp],
        # K4, K5 (cull_kernels.cu)
        "rt_cull_cast": [vp, vp, ci, vp, vp, ci, ci, vp, vp, ci, vp,
                         vp, ci, vp, vp, vp, vp, vp, ci, vp],
        "rt_cull_occlude": [vp, vp, vp, ci, vp, vp, ci, ci, vp, vp, ci,
                            vp, vp, vp, ci, vp],
        # K6 (mxu_kernel.cu)
        "rt_mxu_cast": [vp, vp, ci, vp, ci, ci, vp, vp, ci, ci,
                        vp, vp, vp, vp, vp, vp, vp, ci, vp],
        "rt_mxu_workers": [ci],
        "rt_mxu_split": [],
        # a round's shading around its shadow queries (shade_kernels.cu)
        "rt_shade_rays": [vp] * 9 + [ci, ci] + [vp] * 7 + [ci, vp],
        "rt_shade_phong": [vp] * 8 + [ci, ci, vp, ci, vp],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ci
    return lib


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
