"""Escape-time iteration rules on torch tensors (port of
``fractal_tpu/models/rules.py``).

A rule is ``step(zr, zi, cr, ci) -> (zr', zi')`` over real pairs, written
with mul/add/sub/abs only and in the JAX package's evaluation order, so
the plain versions and the CUDA kernel (``csrc/escape.cu``) round alike.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Rule = Callable[..., Tuple]


def _square_step(zr, zi, cr, ci):
    """z² + c (calc/src/lib.rs:87-92): re' = re² − im², im' = 2·re·im."""
    zr2 = zr * zr
    zi2 = zi * zi
    return zr2 - zi2 + cr, 2.0 * (zr * zi) + ci


def _burning_ship_step(zr, zi, cr, ci):
    """(|Re z| + i·|Im z|)² + c."""
    ar = torch.abs(zr)
    ai = torch.abs(zi)
    return ar * ar - ai * ai + cr, 2.0 * (ar * ai) + ci


def _tricorn_step(zr, zi, cr, ci):
    """conj(z)² + c."""
    zr2 = zr * zr
    zi2 = zi * zi
    return zr2 - zi2 + cr, -2.0 * (zr * zi) + ci


def make_multibrot_step(power: int) -> Rule:
    """z^d + c by square-and-multiply, in the JAX package's product order."""
    if power < 2:
        raise ValueError("multibrot power must be >= 2")

    def step(zr, zi, cr, ci):
        br, bi = zr, zi  # z^(2^k)
        wr = wi = None
        n = power
        while n > 0:
            if n & 1:
                if wr is None:
                    wr, wi = br, bi
                else:
                    wr, wi = wr * br - wi * bi, wr * bi + wi * br
            n >>= 1
            if n:
                br, bi = br * br - bi * bi, 2.0 * (br * bi)
        return wr + cr, wi + ci

    return step


RULES = {
    "mandelbrot": _square_step,
    "julia": _square_step,
    "burningship": _burning_ship_step,
    "tricorn": _tricorn_step,
}

#: Algos whose step is z^d + c with d = scene.power.
POWER_ALGOS = ("mandelbrot", "julia", "multibrot")


def eff_power(algo: str, power: int) -> int:
    """Exponent of the z^d term: ``power`` for the z^d + c family, 2 for
    the quadratic folds (burning ship, tricorn)."""
    return power if algo in POWER_ALGOS else 2


def perturb_supported(algo: str, power: int) -> bool:
    """True when a δ-orbit recurrence exists for (algo, power)."""
    return (algo in ("burningship", "tricorn")
            or (algo in POWER_ALGOS and power >= 2))


def get_rule(algo: str, power: int = 2) -> Rule:
    if algo in POWER_ALGOS:
        if power == 2:
            return RULES.get(algo, _square_step)
        return make_multibrot_step(power)
    try:
        return RULES[algo]
    except KeyError:
        raise ValueError(f"no escape-time rule for algo {algo!r}") from None
