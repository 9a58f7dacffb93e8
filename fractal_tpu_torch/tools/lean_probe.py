"""Probe of the p32 δ-orbit kernel's arithmetic on the card (counterpart of
``tools/lean_probe.py``): the entry point that runs kernels G, F and E on
the headline workload.  The kernels' wrappers and plain versions are in
``ops/probe_cuda`` (G, F) and ``ops/perturb_cuda`` (E).

  * kernel G (``probe_cuda.chain``): the port builds every kernel with
    ``-fmad=false`` and holds it bit-equal to a plain version that rounds
    each product and sum; mode ``fma`` equal to ``pinned`` and to the plain
    version, and different from ``fused``, is the measurement that this
    holds;
  * kernel F (``probe_cuda.probe``): the gate is ``base`` and ``dout``
    count-equal to kernel B's dist-only form;
  * kernel E (``perturb_cuda.perturb_packed``), the same orbit read from the
    packed (rows, 8) layout with the glitch test, beside kernel B's glitch
    form.

Run on the card:  python -m fractal_tpu_torch.tools.lean_probe
"""

from __future__ import annotations

import json
import sys

import torch

from fractal_tpu_torch.ops import perturb_cuda, probe_cuda
from fractal_tpu_torch.ops.probe_cuda import CHAIN_MODES, VARIANTS
from fractal_tpu_torch.utils.timing import card_line, event_ms

HEADLINE = dict(width=3000, height=3000, iterations=4000,
                pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                exposure=5.0, inside=False, precision="p32")
CHAIN_SHAPE = (512, 512)
CHAIN_STEPS = 20000


def chain_inputs(device, shape=CHAIN_SHAPE):
    """The microbenchmark's inputs (tools/lean_probe.py:259-263)."""
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=device)
    return full(0.5), full(0.999999), full(1e-7)


def run_chain(device="cuda", shape=CHAIN_SHAPE, steps: int = CHAIN_STEPS):
    """Kernel G in its four modes → (summary, {mode: output}): times, G
    element-steps/s and the three equalities (``fma`` to ``pinned``,
    ``fma`` to the plain version, ``fma`` against ``fused``)."""
    x, a, b = chain_inputs(device, shape)
    out, res = {}, {}
    n = x.numel() * steps
    for mode in CHAIN_MODES:
        ms, res[mode] = event_ms(lambda m=mode: probe_cuda.chain(x, a, b, steps, m))
        out[f"chain_{mode}_ms"] = ms
        out[f"chain_{mode}_gsteps"] = n / ms / 1e6
        print(f"# chain {mode}: {ms:.3f} ms = {n / ms / 1e6:.1f} G elem-steps/s", flush=True)
    plain = probe_cuda.chain_plain(x, a, b, steps, "fma")
    bits = lambda t: t.view(torch.int32)
    out["fma_equals_pinned"] = bool(torch.equal(bits(res["fma"]), bits(res["pinned"])))
    out["fma_equals_plain"] = bool(torch.equal(bits(res["fma"]), bits(plain)))
    out["fma_differs_from_fused"] = not torch.equal(bits(res["fma"]), bits(res["fused"]))
    print(f"# chain: fma == pinned {out['fma_equals_pinned']}, fma == plain "
          f"{out['fma_equals_plain']}, fma != fused {out['fma_differs_from_fused']} "
          f"(fma {float(res['fma'].flatten()[0])!r}, fused "
          f"{float(res['fused'].flatten()[0])!r})", flush=True)
    return out, res


def run_probes(scene_kw=HEADLINE, device="cuda"):
    """Kernel B's dist-only form, kernel F's four variants, kernel E and
    kernel B's glitch form on one view → (summary, outputs): times and count
    mismatches against kernel B in the summary; in the outputs the scene,
    its ``perturb_setup`` state, the packed orbit, and each kernel's tensors
    under ``perturb_dist``, the variant's name, ``perturb_packed`` and
    ``perturb_full``."""
    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.ops import perturb

    scene = Scene(**scene_kw)
    st = perturb.perturb_setup(scene, device)
    kw = dict(height=st.height, width=st.width)
    out = {"n0": int(st.P[8].item()), "n_steps": st.n_steps}
    res = {"scene": scene, "state": st}
    ms, res["perturb_dist"] = event_ms(lambda: perturb_cuda.perturb_dist(
        st.table, st.P, st.n_steps, **kw))
    cnt_b = res["perturb_dist"][1]
    out["kernel_b_ms"] = ms
    print(f"# kernel B dist-only: {ms:.3f} ms", flush=True)
    for variant in VARIANTS:
        ms, r = event_ms(lambda v=variant: probe_cuda.probe(st.table, st.P, st.n_steps,
                                                            variant=v, **kw))
        res[variant] = r
        cnt_v = r[2] if variant == "base" else r[1]
        neq = int((cnt_v != cnt_b).sum())
        out[f"{variant}_ms"] = ms
        out[f"{variant}_cnt_mismatch"] = neq
        print(f"# probe {variant}: {ms:.3f} ms, cnt mismatches vs kernel B: "
              f"{neq}/{cnt_b.numel()}", flush=True)

    # kernel E beside kernel B's glitch form on the same orbit
    packed = res["packed"] = torch.from_numpy(st.orbit.packed).to(device)
    gkw = dict(iterations=scene.iterations, **kw)
    ms_e, e = event_ms(lambda: perturb_cuda.perturb_packed(packed, st.P, st.n_steps, **gkw))
    ms_g, g = event_ms(lambda: perturb_cuda.perturb_full(st.table, st.gtol, st.P,
                                                          st.n_steps, **gkw))
    res["perturb_packed"], res["perturb_full"] = e, g
    out["packed_ms"], out["kernel_b_glitch_ms"] = ms_e, ms_g
    out["packed_equals_glitch_form"] = [
        bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(e, g)]
    out["packed_cnt_mismatch"] = int((e[2] != g[2]).sum())
    out["packed_gl_mismatch"] = int((e[3] != g[3]).sum())
    print(f"# kernel E (packed orbit): {ms_e:.3f} ms; kernel B glitch form {ms_g:.3f} ms; "
          f"zr, zi, cnt, gl equal: {out['packed_equals_glitch_form']}; cnt mismatches "
          f"{out['packed_cnt_mismatch']}, flag mismatches {out['packed_gl_mismatch']} of "
          f"{cnt_b.numel()}", flush=True)
    return out, res


def failures(out: dict) -> list:
    """The gates a summary fails: the build's flags keep a*x + b unfused,
    and the probe's ``base`` and ``dout`` twins count exactly as kernel B
    does.  ``every2`` and ``nofreeze`` are allowed to shift counts."""
    failed = [k for k in ("fma_equals_pinned", "fma_equals_plain", "fma_differs_from_fused")
              if not out[k]]
    return failed + [v for v in ("base", "dout") if out[f"{v}_cnt_mismatch"]]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("error: the probe needs a CUDA device", file=sys.stderr)
        return 2
    out = {"card": card_line()}
    print(f"# {out['card']}", flush=True)
    out.update(run_chain()[0])
    out.update(run_probes()[0])
    print(json.dumps(out))
    failed = failures(out)
    if failed:
        print(f"FAIL: {failed}")
        return 1
    print("PASS: fma == pinned == plain != fused; base and dout count-equal to kernel B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
