"""Banded rendering with checkpoint/resume, for huge renders (port of
``fractal_tpu/tiled.py``).

The image is rendered in horizontal bands of the supersampled grid, each
addressed through an exact global-row map: kernel A's params[15] for f32,
ds32 and dd64 (its plain version on the CPU), ``pixel_grid``'s ``row0`` for
f64 (the f64 kernel on the card).
On the card every band is the one-shot render's own computation, so the
assembled image equals it bit for bit.  On the CPU the one-shot f32 render
takes the grid route, whose pixel → c arithmetic differs from kernel A's,
so a few boundary pixels differ there (``tests/test_torch_tiled.py``
counts them).  Finished bands go to a checkpoint directory as they finish
(``band_<i>.npy`` and ``manifest.json``); a rerun of the same render skips
them.

Escape-time scenes only (the fern's chaos game is a global scatter).
Perturbation-depth scenes band when a checkpoint directory is given: every
band shares the view's reference orbit and resolves its flagged pixels in
global coordinates (``ops/perturb.render_perturb_band``); without one they
take the one-shot render.  With ``mesh=`` (``parallel/sharding.Mesh``) each
band's rows are interleaved across the mesh: the band's start composes with
the stride in the same global-row maps, so every band equals the one-device
band (``render_escape_band_sharded`` on kernel A,
``render_perturb_band_sharded``), and a perturbation render without a
checkpoint keeps the mesh.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.ops import escape_cuda
from fractal_tpu_torch.render import (_device, _render_grid, _render_params, render_u8,
                                      resolve_precision)

# Keys of checkpoints written by this package.  A directory written by the
# JAX package (or an older layout) has another key and is refused as stale.
CKPT_FORMAT = "fractal_tpu_torch/1"


def _band_u8(scene: Scene, start_row: int, rows: int, precision: str, device):
    """Global rows [start_row, start_row + rows) of the supersampled grid of
    an escape-time scene at ``precision``, colored and downsampled, on
    ``device``: f64 on the grid route's band, f32, ds32 and dd64 on kernel A
    with params[15] = start_row."""
    if precision == "f64":
        return _render_grid(scene, precision, device, row0=start_row, rows=rows)
    params = escape_cuda.scene_params(scene, device=device,
                                      dtype=escape_cuda.params_dtype(precision))
    params[15] = float(start_row)
    return _render_params(scene, params, precision, rows)


def _scene_key(scene: Scene, precision: str, band_rows: int) -> str:
    return (CKPT_FORMAT + "|" + repr(sorted((k, str(v)) for k, v in scene.__dict__.items()))
            + f"|{precision}|{band_rows}")


def _write_manifest(path: str, scene_key: str, done) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"scene_key": scene_key, "done": sorted(done)}, f)
    os.replace(tmp, path)


def render_tiled(scene: Scene, band_rows: int = 512, ckpt_dir: Optional[str] = None,
                 progress: Optional[Callable[[str], None]] = None, mesh=None,
                 device="cuda") -> np.ndarray:
    """Render ``scene`` in bands of ``band_rows`` rows of the supersampled
    grid (rounded down to a multiple of the supersample factor; the last
    band may be shorter) → the (height, width, 3) uint8 host image.

    With ``ckpt_dir``, each finished band is saved as ``band_<i>.npy`` and
    listed in ``manifest.json`` with the render's key; a rerun of the same
    render loads the listed bands and renders the rest.  A manifest of
    another render (scene, precision, band size, or a checkpoint not
    written by this package) raises ``ValueError``.  ``progress`` receives a
    line per rendered band.  ``mesh`` renders each band across a mesh (on
    its first device instead of ``device``); f64 and dd64 are refused
    there, as the reference refuses them."""
    if scene.algo == "fern":
        raise ValueError("banded rendering applies to escape-time scenes; "
                         "the fern chaos game is a global scatter")
    from fractal_tpu_torch.parallel import sharding

    device = mesh.home if mesh is not None else _device(device)
    precision = resolve_precision(scene, device)
    perturb = precision in ("perturb", "p32")
    if perturb and ckpt_dir is None:
        # nothing to persist: the one-shot render does the same work in one pass
        if progress:
            progress("perturbation path without a checkpoint: one-shot render, "
                     "--bands ignored")
        if mesh is not None:
            return sharding.render_perturb_sharded(scene, mesh,
                                                   fast=precision == "p32").cpu().numpy()
        return render_u8(scene, device).cpu().numpy()
    if mesh is not None and not perturb and precision not in escape_cuda.PRECISIONS:
        raise sharding.unsupported_precision(precision)

    ss = scene.supersample
    h = scene.height * ss
    band_rows = max(ss, (band_rows // ss) * ss)  # keep the downsample aligned
    n_bands = -(-h // band_rows)
    if perturb and mesh is not None:
        def band_u8(start, rows):
            return sharding.render_perturb_band_sharded(scene, start, rows,
                                                        fast=precision == "p32", mesh=mesh)
    elif perturb:
        from fractal_tpu_torch.ops.perturb import render_perturb_band

        def band_u8(start, rows):
            return render_perturb_band(scene, start, rows, device,
                                       fast=precision == "p32")
    elif mesh is not None:
        # kernel A on every device, as the one-device bands take it
        def band_u8(start, rows):
            return sharding.render_escape_band_sharded(scene, start, rows, precision, mesh,
                                                       backend="pallas")
    else:
        def band_u8(start, rows):
            return _band_u8(scene, start, rows, precision, device)

    scene_key = _scene_key(scene, precision, band_rows)
    manifest_path = os.path.join(ckpt_dir, "manifest.json") if ckpt_dir else None
    done = set()
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                m = json.load(f)
            if m.get("scene_key") != scene_key:
                raise ValueError(
                    f"checkpoint dir {ckpt_dir} holds a different render "
                    "(scene/precision/band mismatch); use a fresh directory")
            done = set(m.get("done", []))

    bands = []
    for b in range(n_bands):
        start = b * band_rows
        rows = min(band_rows, h - start)
        want = (rows // ss, scene.width, 3)
        band_path = os.path.join(ckpt_dir, f"band_{b}.npy") if ckpt_dir else None
        if b in done and os.path.exists(band_path):
            band = np.load(band_path)
            if band.shape != want or band.dtype != np.uint8:
                raise ValueError(f"checkpoint band {band_path} is {band.dtype}{band.shape}, "
                                 f"not uint8{want}; use a fresh directory")
        else:
            band = band_u8(start, rows).cpu().numpy()
            if ckpt_dir:
                np.save(band_path, band)
                done.add(b)
                _write_manifest(manifest_path, scene_key, done)
            if progress:
                progress(f"band {b + 1}/{n_bands} ({rows} rows)")
        bands.append(band)
    return np.concatenate(bands, axis=0)
