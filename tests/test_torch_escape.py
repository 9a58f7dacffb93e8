"""Kernel A's plain version (``fractal_tpu_torch.ops.escape_cuda``) against
``escape_pallas.iterate_params(..., interpret=True)``, and the escape goldens
through the port's CPU ``render_u8``.

Counts are compared at views inside each number format's range, where the
two agree exactly (measured: 0 mismatches at every case below).  The
final z is not: XLA:CPU contracts a*b + c into FMAs inside the jitted
reference (see test_torch_foundations.py) and the port never fuses, so
z_final differs in its last bits and the difference grows along chaotic
orbits.  The goldens carry per-image bounds for the same reason.
"""

import os

import numpy as np
import pytest

from fractal_tpu.config import Scene
from fractal_tpu.ops import escape_pallas as jep
from fractal_tpu_torch import interop, render_u8
from fractal_tpu_torch.ops import escape_cuda as tec
from tests.test_goldens import GOLDENS

DEEP = (-0.7436447860, 0.1318252536)

CASES = {
    "f32-mandelbrot-cli": (Scene(width=200, height=100, iterations=50, pos=(-0.6, 0.0)),
                           "f32", False),
    "f32-julia": (Scene(algo="julia", width=64, height=48, iterations=100,
                        julia_set=(-0.8, 0.156), pos=(0.3, 0.1), scale=(0.5, 0.5)),
                  "f32", True),
    "f32-burningship": (Scene(algo="burningship", width=64, height=48, iterations=30,
                              pos=(-1.6, 0.0), scale=(2.0, 2.0)), "f32", False),
    "f32-tricorn": (Scene(algo="tricorn", width=64, height=48, iterations=100,
                          pos=(-0.3, 0.0)), "f32", False),
    "f32-multibrot3": (Scene(algo="multibrot", power=3, width=64, height=48,
                             iterations=100), "f32", True),
    "ds32-mandelbrot-period": (Scene(width=96, height=64, iterations=300, pos=DEEP,
                                     scale=(5e5, 5e5)), "ds32", True),
    "ds32-mandelbrot": (Scene(width=96, height=64, iterations=300, pos=DEEP,
                              scale=(5e5, 5e5)), "ds32", False),
    "ds32-julia-period": (Scene(algo="julia", width=48, height=32, iterations=300,
                                julia_set=(-0.8, 0.156),
                                pos=(-1.1979166666666665, 0.15625),
                                scale=(2e4, 2e4)), "ds32", True),
    "ds32-burningship": (Scene(algo="burningship", width=48, height=32, iterations=60,
                               pos=(-1.62, -0.01), scale=(2e4, 2e4)), "ds32", False),
    "ds32-tricorn-period": (Scene(algo="tricorn", width=48, height=32, iterations=300,
                                  pos=(0.37708333333333327, 0.46875),
                                  scale=(2e4, 2e4)), "ds32", True),
    "ds32-multibrot3": (Scene(algo="multibrot", power=3, width=48, height=32,
                              iterations=300, pos=(-0.5729166666666666, -0.3125),
                              scale=(1e5, 1e5)), "ds32", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_a_plain_matches_reference(name):
    sc, precision, periodicity = CASES[name]
    params = jep.scene_params(sc)
    kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations,
              precision=precision, height=sc.height, width=sc.width,
              periodicity=periodicity)
    zr, zi, cnt = jep.iterate_params(params, interpret=True, **kw)
    tzr, tzi, tcnt = tec.iterate_params(interop.params16(params), **kw)
    assert tcnt.dtype.is_floating_point is False and tuple(tcnt.shape) == cnt.shape
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    assert len(np.unique(np.asarray(cnt))) > 5  # the view has structure
    assert np.isfinite(tzr.numpy()).all() and np.isfinite(tzi.numpy()).all()
    # bounded orbits stay bounded: interior pixels end inside the limit
    inside = tcnt.numpy() == sc.iterations
    assert (tzr.numpy()[inside] ** 2 + tzi.numpy()[inside] ** 2 <= sc.limit ** 2).all()


# Measured pixel mismatches of the port's CPU render against each golden
# (rendered by the JAX package on the CPU), and why they are not zero.
GOLDEN_BOUNDS = {
    # 2 of 3,750: boundary pixels, contraction in the jitted f32 program
    "mandelbrot_default": 4,
    # 13 of 3,072: the same, on a julia boundary
    "julia_morph": 26,
    # 0 of 3,200
    "deep_ds32": 0,
    # 786 of 3,072: the f32 burning ship is chaotic inside the set; 198
    # counts flip (test_burningship_golden_counts) and the inside shading
    # (secondary·|z_final|²) follows z_final, which contraction moves on
    # most interior pixels
    "burningship": 800,
}


@pytest.mark.parametrize("name", sorted(GOLDEN_BOUNDS))
def test_escape_goldens_through_port(name):
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens", f"{name}.npy"))
    img = render_u8(interop.scene(GOLDENS[name]), "cpu").numpy()
    assert img.shape == golden.shape and img.dtype == golden.dtype
    mismatched = int((img != golden).any(-1).sum())
    assert mismatched <= GOLDEN_BOUNDS[name], mismatched


def test_burningship_golden_counts():
    """The burning ship golden's counts on their own.  Unfused (jit
    disabled) the JAX route's counts equal the port's on every pixel; the
    jitted route, which made the golden, flips 198 of 3,072 (measured)."""
    import jax
    import jax.numpy as jnp
    import torch

    from fractal_tpu.models.rules import get_rule as jget_rule
    from fractal_tpu.ops import escape_jnp as jej
    from fractal_tpu.ops import viewport as jvp
    from fractal_tpu_torch.models.rules import get_rule as tget_rule
    from fractal_tpu_torch.ops import escape as tes
    from fractal_tpu_torch.ops import viewport as tvp

    sc = GOLDENS["burningship"]
    w, h, n = sc.width, sc.height, sc.iterations

    def jax_counts():
        cr, ci = jvp.pixel_grid(w, h, sc.pos, sc.scale, dtype=jnp.float32)
        return jej.iterate(cr, ci, cr, ci, n, sc.limit, jget_rule(sc.algo, sc.power))[2]

    cr, ci = tvp.pixel_grid(w, h, sc.pos, sc.scale, dtype=torch.float32, device="cpu")
    port = tes.iterate(cr, ci, cr, ci, n, sc.limit, tget_rule(sc.algo, sc.power))[2].numpy()
    with jax.disable_jit():
        unfused = np.asarray(jax_counts())
    np.testing.assert_array_equal(port, unfused)
    jitted = np.asarray(jax.jit(jax_counts)())
    assert int((port != jitted).sum()) <= 200
    assert 0 < int((port == n).sum()) < port.size  # interior and exterior


def test_periodicity_freezes_interior_early():
    """Brent detection changes no escaped count, and marks the interior
    with cnt = iterations (escape_pallas._iterate_tile semantics)."""
    sc = Scene(width=64, height=48, iterations=400, pos=DEEP, scale=(5e5, 5e5))
    p = interop.params16(jep.scene_params(sc))
    kw = dict(algo="mandelbrot", power=2, iterations=400, precision="ds32",
              height=48, width=64)
    _, _, on = tec.iterate_params(p, periodicity=True, **kw)
    _, _, off = tec.iterate_params(p, periodicity=False, **kw)
    esc = off.numpy() < 400
    np.testing.assert_array_equal(on.numpy()[esc], off.numpy()[esc])
    assert (on.numpy()[~esc] == 400).all()
