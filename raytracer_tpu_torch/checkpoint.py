"""Checkpoint / resume of differentiable-rendering parameters.

Counterpart of ``raytracer_tpu/checkpoint.py``: a plain ``.npz`` holding
each leaf as ``arr_<i>``, the leaves' key paths (the JAX package's, e.g.
``['materials']/.kd``) and the step.  The keys are stored as a unicode
array, so loading needs no ``allow_pickle``.
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np
import torch

from . import tree


def save(path: str, params: Any, step: int = 0) -> None:
    """Write ``params`` (a tree of tensors) and ``step`` atomically."""
    pairs = tree.leaves_with_paths(params)
    arrays = {f"arr_{i}": v.detach().cpu().numpy()
              for i, (_, v) in enumerate(pairs)}
    arrays["__keys__"] = np.array([k for k, _ in pairs], dtype=np.str_)
    arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load(path: str, like: Any) -> Tuple[Any, int]:
    """Restore a tree saved by :func:`save`, checked against ``like``'s key
    paths and shapes; leaves land on ``like``'s devices and dtypes, with its
    ``requires_grad``.  Returns ``(params, step)``."""
    with np.load(path) as data:
        step = int(data["__step__"])
        saved_keys = data["__keys__"].tolist()
        pairs = tree.leaves_with_paths(like)
        keys = [k for k, _ in pairs]
        if keys != saved_keys:
            raise ValueError(
                f"checkpoint structure mismatch: {len(saved_keys)} saved vs "
                f"{len(keys)} expected leaves")
        values = []
        for i, (k, v) in enumerate(pairs):
            arr = data[f"arr_{i}"]
            if arr.shape != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: {arr.shape} vs "
                                 f"{tuple(v.shape)}")
            values.append(torch.from_numpy(arr).to(device=v.device,
                                                   dtype=v.dtype)
                          .requires_grad_(v.requires_grad))
    return tree.unflatten(like, values), step
