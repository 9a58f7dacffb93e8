"""fractal_tpu_torch — the PyTorch/CUDA port of ``fractal_tpu``.

Still renders of the escape-time fractals on a CUDA device (or the CPU):
the f32 and ds32 escape-time kernel (``csrc/escape.cu``), and the
perturbation tiers down to a pixel spacing of 1e-30 — the p32 fast tier
and the exact tier with glitch detection, multi-reference resolution and
high-precision reference orbits — on the δ-orbit kernels
(``csrc/perturb.cu``), each kernel with a plain torch version beside it.
Imports torch and never jax.
"""

from fractal_tpu_torch.config import RGB, Scene, scene_defaults
from fractal_tpu_torch.render import render, render_u8

__all__ = ["RGB", "Scene", "render", "render_u8", "scene_defaults"]
