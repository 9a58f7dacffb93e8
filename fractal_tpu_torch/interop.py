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
from fractal_tpu_torch.ops.bla import BLATable
from fractal_tpu_torch.ops.perturb import RefOrbit


def params16(block) -> torch.Tensor:
    """A JAX f32[16] parameter block — ``escape_pallas.scene_params``
    (kernel A), ``perturb._pert_params`` (kernels B and C) or
    ``perturb._pert_params_fe`` (kernel D); the port keeps the three
    layouts — as a CPU tensor."""
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


def _lane0(plane) -> np.ndarray:
    arr = np.asarray(plane, dtype=np.float32)
    if arr.ndim != 2 or not (arr == arr[:, :1]).all():
        raise ValueError("orbit planes must be (rows, 128) and lane-replicated")
    return arr[:, 0]


def orbit_table(planes) -> torch.Tensor:
    """The lane-replicated 2·Z planes (``orbit_planes`` 0 and 1, (rows, 128)
    each) → the port's (rows, 2) table."""
    zr2, zi2 = _lane0(planes[0]), _lane0(planes[1])
    if zr2.shape != zi2.shape:
        raise ValueError(f"plane shapes {zr2.shape} and {zi2.shape} differ")
    return torch.from_numpy(np.ascontiguousarray(np.stack([zr2, zi2], 1)))


def glitch_column(planes) -> torch.Tensor:
    """The lane-replicated glitch-tolerance plane (``orbit_planes`` 2) → the
    port's (rows,) column of τ²·|Z_{n+1}|²."""
    return torch.from_numpy(np.ascontiguousarray(_lane0(planes[2])))


def bla_table(jax_table) -> BLATable:
    """A JAX ``BLATable`` (``bla.build_table_fe``: packed (rows, 8) f32,
    offsets, levels) → the port's."""
    packed = np.array(np.asarray(jax_table.packed), dtype=np.float32)
    if packed.ndim != 2 or packed.shape[1] != 8:
        raise ValueError(f"packed BLA table must be (rows, 8), got {packed.shape}")
    offsets = tuple(int(o) for o in jax_table.offsets)
    if len(offsets) != int(jax_table.levels):
        raise ValueError(f"{len(offsets)} offsets for {jax_table.levels} levels")
    return BLATable(packed, offsets, int(jax_table.levels))


def prng_key(key_data):
    """A JAX threefry key's data (``jax.random.key_data``, uint32[2]) → the
    port's key, a pair of Python integers (``ops/threefry``)."""
    arr = np.asarray(key_data)
    if arr.shape != (2,) or arr.dtype != np.uint32:
        raise ValueError(f"expected uint32[2] key data, got {arr.dtype}{arr.shape}")
    return int(arr[0]), int(arr[1])


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
