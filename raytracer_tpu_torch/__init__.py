"""raytracer_tpu_torch — the PyTorch/CUDA port of ``raytracer_tpu``.

Cube-world rendering and its training step on an NVIDIA GPU: the same
scene model, world loader and wavefront shading as the JAX package, with
each of its Pallas kernels (the LBVH walk's closest hit and shadow queries,
the candidate-list cull's, and the MXU cast) rewritten as a hand-written
CUDA kernel (``csrc/``).  Imports torch and numpy only, never JAX.
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
