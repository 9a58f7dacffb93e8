"""fractal_tpu_torch — the PyTorch/CUDA port of ``fractal_tpu``.

Still renders of the escape-time fractals on a CUDA device (or the CPU):
the f32 and ds32 escape-time kernel (``csrc/escape.cu``) and the p32
dist-only δ-orbit kernel (``csrc/perturb.cu``), each with a plain torch
version beside it.  Imports torch and never jax.
"""

from fractal_tpu_torch.config import RGB, Scene, scene_defaults
from fractal_tpu_torch.render import render, render_u8

__all__ = ["RGB", "Scene", "render", "render_u8", "scene_defaults"]
