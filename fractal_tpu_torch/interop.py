"""Carry state from the JAX package into the port.

The tests feed both packages the same inputs through these functions.
Nothing here imports jax: JAX arrays are read through ``np.asarray``, and a
JAX ``Scene`` (or ``RefOrbit``) is read by its plain attributes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fractal_tpu_torch.config import RGB, Scene
from fractal_tpu_torch.ops.perturb import RefOrbit


def params16(block) -> torch.Tensor:
    """A JAX f32[16] parameter block — ``escape_pallas.scene_params``
    (kernel A) or ``perturb._pert_params`` (kernel B); the port keeps
    both layouts — as a CPU tensor."""
    arr = np.array(np.asarray(block), dtype=np.float32)
    if arr.shape != (16,):
        raise ValueError(f"expected a (16,) block, got {arr.shape}")
    return torch.from_numpy(arr)


def ref_orbit(jax_orbit) -> RefOrbit:
    """A JAX ``RefOrbit`` (packed (rows, 8) f32, n_steps, ref_px) → the port's."""
    packed = np.ascontiguousarray(np.asarray(jax_orbit.packed), dtype=np.float32)
    if packed.ndim != 2 or packed.shape[1] != 8:
        raise ValueError(f"packed orbit must be (rows, 8), got {packed.shape}")
    return RefOrbit(packed.copy(), int(jax_orbit.n_steps),
                    tuple(jax_orbit.ref_px))


def orbit_table(planes) -> torch.Tensor:
    """The lane-replicated 2·Z planes ((rows, 128) each; the third, glitch
    plane is ignored) → the port's (rows, 2) table."""
    zr2 = np.asarray(planes[0], dtype=np.float32)
    zi2 = np.asarray(planes[1], dtype=np.float32)
    if zr2.shape != zi2.shape or zr2.ndim != 2:
        raise ValueError(f"plane shapes {zr2.shape} and {zi2.shape} differ")
    if not ((zr2 == zr2[:, :1]).all() and (zi2 == zi2[:, :1]).all()):
        raise ValueError("orbit planes are not lane-replicated")
    return torch.from_numpy(np.ascontiguousarray(np.stack([zr2[:, 0], zi2[:, 0]], 1)))


def scene(jax_scene) -> Scene:
    """A JAX ``Scene``'s field values → a port ``Scene``."""
    kw = {}
    for f in dataclasses.fields(Scene):
        v = getattr(jax_scene, f.name)
        if f.name in ("primary_color", "secondary_color"):
            v = RGB(int(v.r), int(v.g), int(v.b))
        elif isinstance(v, tuple):
            v = tuple(v)
        kw[f.name] = v
    return Scene(**kw)
