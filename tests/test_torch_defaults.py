"""The port's defaults against the JAX package's.

A default that differs changes what a call without that argument does, with
no error: ``render_perturb``'s ``fast`` once defaulted to the p32 tier in the
port and to the exact tier in the reference.  These tests read the sources of
both packages (no heavy import) and require every parameter that two
same-named functions share to default alike, then pin ``render_perturb``'s
default by what it renders.
"""

import ast
import inspect
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["ops/perturb.py", "models/fern.py", "ops/bla.py", "ops/coloring.py",
           "ops/viewport.py", "config.py", "animate.py", "tiled.py"]
# a dtype default names its framework's module: jnp.float32 is torch.float32
FRAMEWORKS = ("jax.numpy.", "jnp.", "np.", "numpy.", "torch.")


def _functions(path):
    """{qualified name: {parameter: default source}} of the functions and
    methods defined in ``path``."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = child.args
                positional = a.posonlyargs + a.args
                pairs = list(zip(positional[len(positional) - len(a.defaults):], a.defaults))
                pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
                out[prefix + child.name] = {p.arg: _neutral(ast.unparse(d)) for p, d in pairs}

    visit(tree, "")
    return out


def _neutral(src: str) -> str:
    for fw in FRAMEWORKS:
        if src.startswith(fw):
            return "<framework>." + src[len(fw):]
    return src


@pytest.mark.parametrize("module", MODULES)
def test_shared_parameters_default_alike(module):
    ref = _functions(os.path.join(ROOT, "fractal_tpu", module))
    port = _functions(os.path.join(ROOT, "fractal_tpu_torch", module))
    shared = sorted(set(ref) & set(port))
    assert shared, f"{module}: no function in common"
    differ = [(name, p, ref[name][p], port[name][p]) for name in shared
              for p in sorted(set(ref[name]) & set(port[name]))
              if ref[name][p] != port[name][p]]
    assert not differ, f"{module}: defaults differ (function, parameter, reference, port): {differ}"


def test_render_perturb_defaults_to_the_exact_tier():
    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.ops import perturb as tpt

    assert inspect.signature(tpt.render_perturb).parameters["fast"].default is False
    sc = Scene(width=24, height=16, iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16),
               precision="perturb")
    default = tpt.render_perturb(sc, "cpu")
    assert tpt.RENDER_STATS["tier"] == "perturb"
    exact = tpt.render_perturb(sc, "cpu", fast=False)
    fast = tpt.render_perturb(sc, "cpu", fast=True)
    assert tpt.RENDER_STATS["tier"] == "p32"
    np.testing.assert_array_equal(default.numpy(), exact.numpy())
    assert default.shape == fast.shape == (16, 24, 3)
