"""raytracer_tpu_torch — the PyTorch/CUDA port of ``raytracer_tpu``.

The forward cube-world render path on an NVIDIA GPU: the same scene model,
world loader and wavefront shading as the JAX package, with its two LBVH
Pallas kernels (closest hit and the fused two-light shadow query) rewritten
as hand-written CUDA kernels (``csrc/``).  Imports torch and numpy only,
never JAX.
"""

from .scene import (Camera, Lights, Materials, RenderConfig, Scene,
                    scene_render_flags, to_device)
from .builder import Material, SceneBuilder, TextureCoords
from .cube_world import GeneratedWorld, generate

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GeneratedWorld",
    "Lights",
    "Material",
    "Materials",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "TextureCoords",
    "generate",
    "scene_render_flags",
    "to_device",
    "__version__",
]
