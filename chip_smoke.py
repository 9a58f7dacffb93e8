#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:
  1. the card's name and power limit (nvidia-smi), PyTorch and mpmath;
  2. the kernel build (nvcc, one process per ``fractal_tpu_torch/csrc/*.cu``)
     and the native orbit walker's (g++, ``native/orbitwalk.cpp``), with
     their times, and ptxas's registers and spills for each δ-orbit kernel;
  3. the headline main path: ``render_u8(scene, "cuda")`` on the 3000×3000
     @1e6× / 4000-iteration view in p32 and in auto (ds32), cold and warm,
     with kernel A's and kernel B's counters zeroed before and read after;
  4. every kernel against its plain torch version on the card, bit for bit:
     kernel A (f32, ds32, five rules), kernel B's dist-only form (every
     δ-recurrence), its full and glitch forms (every rule, a forced bad
     reference, 20,000 iterations, an odd series start with n_steps − n0
     even and odd, exits on both steps of the loop's two-step passes),
     kernel C on a flagged list, on a list of every rule's view with the
     glitch test on and off, at an odd series start with n_steps − n0 even
     and odd, and at 20,000 iterations (its shared-memory ring), kernel A's
     points form (also against its grid form);
  5. the headline kernels at their 3000×3000 shape against their plain
     versions (kernel B's warp efficiency for 32×1 and 8×4 warps), kernel
     A's colored ds32 form also at a centre of the benchmark's
     ``stills_around`` mix (against ``iterate_color_plain``), its device
     time by the profiler and its loop's instructions a step from
     ``cuobjdump -sass``, and the main path's images against the plain
     route's, at 3000×3000 and at 1000×1000 of the same view;
  6. the deep path: ``render_u8(scene, "cuda")`` with precision auto on
     ``bench.py``'s dz1e12 (3000×3000 @1e12×, 4000) and p1e15 (1920×1080
     @1e15×, 5000), each cold from empty host caches with a fenced split,
     3 warm calls and a 7-pixel pan, tier perturb and no unresolved pixel;
     the counters of kernels B (full) and C zeroed before and read after;
  7. the same orchestration on the plain versions on the card: the same
     image, glitch and residual counts as the kernel route, cold;
  8. the ds32 fallback of an explicit ``precision="perturb"`` render above
     spacing 1e-13 on kernel A's points form (its counter zeroed before,
     read after);
  9. each deep-path kernel at its main-path shape against its plain version
     (kernel C on dz1e12's and p1e15's first lists), kernel B's warp
     efficiency at dz1e12 and p1e15, the SM clock under load, the latency
     floor of the points forms C and A beside their bounds, and kernel C's
     measured floor: the list's longest pixel alone;
 10. kernel D against its plain version, bit for bit: the grid form with
     glitch on and off at ``bench.py``'s fe1e44 (768×512 @1e44×, 2000) and
     at a julia view, the points form on the flagged list of a forced bad
     reference, and fe1e44_11k at its full 11,000 iterations;
 11. the floatexp path: ``render_u8(scene, "cuda")`` with precision auto on
     fe1e44 and fe1e44_11k, each cold from empty host caches with a fenced
     split, 3 warm calls and a 7-pixel pan, tier floatexp on kernel D and no
     unresolved pixel; kernel D's counters zeroed before and read after;
 12. bla1e40 (512×384 @1e40×, 4000) through the fe BLA kernel
     (csrc/perturb_bla_fe.cu, one launch a render in its register form:
     cold with its split, 3 warm frames equal to it, no unresolved pixel),
     and fe1e44 in p32 through kernel D's grid form without the glitch
     test; the fe BLA kernel bit-equal to its plain version with the glitch
     test on and off, in the state form the wrapper picks (each form's
     counter read to show it ran): registers at bla1e40, at a 300-row crop
     of its view (a padded gate group), at the minibrot's edge (every pixel
     escapes after the skips), at the crop with seeded orbit rows and
     tables that leave the closed domain, and at fe1e44's first gate group
     against the corner reference (escapes, glitches, ran-out); streaming
     at the whole fe1e44 against that reference and at a 2048×512 crop of
     bla1e40's view; bla1e40 through the same orchestration on the plain
     versions and in 96-row bands (each image equal to the kernel route's),
     and the kernel's time in both state forms beside its plain version's,
     its bound (the work its plain version counts), its latency floor (the
     chain of dependent phases) and its phases;
 13. the same orchestration on the plain versions on the card at a 96×64
     crop of fe1e44's view (its centre and pixel spacing): the same image,
     glitch and residual counts as the kernel route's cold render of the
     crop, with the phase's time;
 14. kernel D's two forms at their main-path shapes against their plain
     versions, and the points form's latency floor;
 15. kernel H against its plain version, bit for bit: a real 5-step stream
     of the fern at 2000×2000, the same stream with drop sentinels and
     negative indices mixed in, every point in one bin, fern_10m's 375,000
     bins and a supersample=2 fern_100m's 16,000,000, each added into a
     histogram that already holds counts;
 16. the fern path: ``render_u8(scene, "cuda")`` on ``bench.py``'s fern_100m
     (2000×2000, 100,000,000 points) and fern_10m (750×500, 10,000,000),
     each cold with a fenced split and 3 warm calls, fern_10m once with 4
     replicas and once with supersample=2; kernel H's counter zeroed before
     and read after; the same renders with the plain histogram give the same
     images; the card's uniforms and a 200×200 fern equal the CPU's;
 17. kernel H at its main-path launch beside ``torch.bincount`` and
     ``index_add_`` on the same resident batch, and its diagnosis
     (``fern_hist.diagnose``: the batch, distinct bins and the batch sorted
     by bin) there, at fern_10m and at supersample=2;
 18. the probe entry point's runs (``tools/lean_probe.run_chain`` and
     ``run_probes``, with its gates) with the counters of kernels G, F and E
     zeroed before and read after, and kernel G's modes against their plain
     versions: ``fma`` equal to ``pinned`` and to the plain version, and
     different from the explicit FMA;
 19. kernel F's four variants at the 3000×3000 headline against their plain
     versions, ``base`` and ``dout`` count-equal to kernel B;
 20. kernel E at the headline's shape against its plain version and against
     kernel B's glitch form;
 21. sweeps through ``fractal_tpu_torch.animate``: ``bench.py``'s jsweep256
     (256 julia frames at 1920x1080 / 300 on kernel A's f32 form, a cold
     call and a warm p50 of 3; frames 0, 100 and 255 against their stills;
     16 frames under the profiler, with the device's launches a frame), a
     mid-depth ds32 sweep (8 frames at
     1080p, each against its still), zoom sweeps at dz1e12's centre (16
     fast frames 1e2-1e12 at 1080p / 4000; exact at 1e6, 1e11, 1e12) and
     at fe1e44's needle (exact at 1e38, 1e44), each exact frame against its
     still with no unresolved pixel;
 22. banded renders through ``fractal_tpu_torch.tiled`` against one-shot:
     mp100 (10000x10000 / 500, f32) in 512-row bands with a checkpoint,
     resumed after two bands are removed (exactly those two re-rendered)
     and refused for a changed scene; m4k_ss2 (ds32, supersample 2) in
     333-row bands; p1e15 and fe1e44 in p32 with a checkpoint (bit-equal)
     and in the exact tier (no unresolved pixel in any band, every pixel no
     band flagged equal);
 23. kernel A's colored form (the epilogue of ops/coloring.py in the kernel,
     the route of every supersample-1 still, band and sweep frame of the f32
     and ds32 tiers) against its plain version, bit for bit, at 256x192 for
     every rule in f32 and ds32, with periodicity on and off, inside and
     smooth on and off, 300 iterations over the whole image and 301 over a
     band (params[15] = 37), the three-output form on the same cases; both
     forms at a jsweep256 frame (the colored against iterate_color_plain) and
     at mp100 (the colored against the three-output form and torch's
     coloring on the card): their times by CUDA events and on the device by
     the profiler, pixel-steps, warp efficiency (32x1 and 8x4 tiles) and
     bounds; the instructions of the f32 loop a step from ``cuobjdump
     -sass``; libdevice's log2f and sqrtf against torch.log2 and torch.sqrt
     on all 2^32 float32 bit patterns;
 24. bench.py's julia_1080p, mb3_2k and bship_2k through
     ``render_u8(scene, "cuda")``: cold, warm p50 of 3, one colored launch a
     render, each image bit-equal to the plain route's (iterate_color_plain);
 25. f64 words: kernel A's dd64 form (``escape_time_dd64``) and the f64
     kernel (``escape_time_f64``, csrc/escape_f64.cu) bit-equal to their
     plain versions at 256x192 on every rule (dd64 with periodicity on and
     off), 300 iterations whole and 301 on a band from global row 37;
     dz1e12 and the headline at dd64 through ``render_u8(scene, "cuda")``
     (cold, warm p50 of 3, one dd64 launch a render; the share of pixels
     that differ from phase 6's exact image and from the ds32 headline, and
     which way the black ones go); the headline at f64 through the f64
     kernel (one launch a render, the image bit-equal to the plain route's);
     dz1e12 dd64 at 1000x1000 in bands of 333 rows and a 4-frame dd64 zoom
     sweep, equal to one-shot and the stills; kernel A dd64 at dz1e12's
     3000x3000 with periodicity (the main path's launch) and without,
     each bit-equal to its plain version, what Brent's test froze, 16
     sampled escaping pixels equal to 50-digit mpmath and 16 that the main
     path calls interior held there without periodicity; each kernel's
     time at its main-path shape (CUDA events, and the profiler's, read in
     a process of its own), pixel-steps and the bound at the f64 rate of
     64 lanes an SM;
 26. the viewer, ``--trace`` and ``--backend``: the f32 grid loop
     (csrc/escape_f64.cu; carried squares, two steps a pass, 8x4 warp
     tiles): the c that its colored form forms in the kernel bit-equal to
     ``pixel_grid`` at 1920x1080 on every rule's view, whole and on a band;
     the three-output form (``escape_time_f32_grid``) bit-equal to
     ``iterate_grid_plain`` and the colored form
     (``escape_time_f32_grid_color``) to ``color_plain`` of the same run on
     66 cases (every rule and a cubic julia at 256x192, whole at 300 and on a
     band at 301, budgets 0-3, 250x190, limit 1e20 where every exterior pixel
     runs on as NaN, a wide view whose corners start outside the limit);
     ``render_u8(..., backend="jnp")`` at mp100's view in 1080p one launch
     of the colored form a render and at supersample 2 one of the
     three-output form (cold, warm p50 of 3, each image bit-equal to the
     plain grid route's); each form's time by events and by the profiler
     in a process of its own (with kernel A's points form at phase 9's
     shape) beside its bound, warp efficiency (rows of 32 against 8x4
     tiles) and SASS instructions a pass; ``backend="pallas"`` at f64 equal
     to the f32 colored route's; ``viewer.start`` in this process
     on the card at 1920x1080: the first frame (kernel A colored), dz1e12's
     centre by POST /pos (kernel B, no residual) and five pans, fe1e44's
     needle at 768x512 (kernel D), /reset to julia and to the fern at 1080p
     (kernel H), 15 rapid posts (1-5 renders), the 2x screenshot, every frame
     equal to ``render(scene, "cuda")``, with each frame's device, render,
     encode and request-to-PNG times; ``python -m fractal_tpu_torch 1920
     1080 --trace DIR``, whose trace holds kernel A's colored launch;
 27. the device mesh (``fractal_tpu_torch/parallel``) on logical meshes of
     several shards on this card, each render bit-equal to
     ``render_u8(scene, "cuda")`` from the same cleared caches and its warm
     p50 beside one device's: the headline in the exact (auto) and p32 tiers
     on 2, 4 and 7 shards (one launch of kernel A's colored form or kernel
     B's dist-only form a shard), dz1e12 and fe1e44 on 4 shards (one kernel
     B or D grid launch a shard, no unresolved pixel), bla1e40 on the fe BLA
     kernel (one launch a stripe, its differing pixels held at
     ``BLA_MESH_DIFF``), fern_100m in
     the exact mode (kernel H's launches four times one device's),
     jsweep256 frame-parallel, mp100 in 20 bands across 4 shards with a
     checkpoint and a resume of two removed bands (== one-shot), two
     ``viewer.RenderWorker(mesh=)`` frames, the CLI's ``--devices 0`` PNG
     against ``--devices 1``'s and ``--devices 2``'s refusal, and
     ``python -m fractal_tpu_torch.tools.dryrun_mesh 4 --ranks 2`` (two
     rank processes over gloo on this card); within 90 s;
 28. the CPU's own route beside the card's: a quadratic mid-zoom view
     (``F32_BLA_VIEW``, 240×135 at the spiral at 1e13×, 2000) through
     ``render_u8(scene, "cpu")`` in p32 and exact takes the f32 BLA route
     (plain torch on the host, as the reference's CPU route), and through
     ``render_u8(scene, "cuda")`` kernel B's (its counter zeroed before and
     read after); the card's route run on the CPU (``CARD_ROUTE``) equals
     the card's image bit for bit, the f32 BLA image differs from it on at
     most ``F32_BLA_MISMATCH`` pixels (tests/test_torch_bla.py states it);
     each render's wall time, and the phase's.
The launch counters are zeroed before each path and read after it.
The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  No JAX is imported.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from fractions import Fraction

A_SRC = "fractal_tpu_torch/csrc/escape.cu"
B_SRC = "fractal_tpu_torch/csrc/perturb.cu"
A_REPLACES = "fractal_tpu/ops/escape_pallas.py:388"
A_POINTS_REPLACES = "fractal_tpu/ops/perturb.py:1932"
B_REPLACES = "fractal_tpu/ops/perturb.py:1466"
C_REPLACES = "fractal_tpu/ops/perturb.py:1550"
D_SRC = "fractal_tpu_torch/csrc/perturb_fe.cu"
D_REPLACES = "fractal_tpu/ops/perturb.py:1841"
BLA_SRC = "fractal_tpu_torch/csrc/perturb_bla_fe.cu"
# the fe BLA route: an XLA program, no Pallas
BLA_REPLACES = "fractal_tpu/ops/perturb.py:915"
E_REPLACES = "fractal_tpu/ops/perturb.py:1906"
F_SRC = "fractal_tpu_torch/csrc/perturb_probe.cu"
F_REPLACES = "tools/lean_probe.py:181"
G_SRC = "fractal_tpu_torch/csrc/chain.cu"
G_REPLACES = "tools/lean_probe.py:218"
H_SRC = "fractal_tpu_torch/csrc/hist.cu"
H_REPLACES = "tools/fern_hist_pallas.py:110"
A64_SRC = "fractal_tpu_torch/csrc/escape_f64.cu"
DD64_REPLACES = "fractal_tpu/ops/escape_pallas.py:388"
# the grid loop on f64 and on f32 words: an XLA program, no Pallas
GRID_REPLACES = "fractal_tpu/ops/escape_jnp.py:30"

# The card's f32 operation rate without FMA (132 SMs x 128 lanes x 1.98
# GHz) and its memory rate (NVIDIA's H100 SXM data sheet: 3.35 TB/s).
PEAK_OPS = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12
# f32 operations per loop step, counted from the sources (each add, mul,
# compare and select is one): kernel A ds32 quad_step ~77 + escape test
# and bookkeeping, the step as ops/dd.py writes it, with Dekker's splits (the
# benchmark's kernel_a_roofline counts the same 80, portbench/counts; the
# kernel forms each exact product error in one FMA and takes |z|^2's squares
# as p1 and p2, 46 for quad_step, and phase 5 prints its loop's instructions);
# kernel B quadratic: 10 for dz', 2 for Z_{n+1}, 2 for z, 3 for |z|^2, 1 for
# the live test, +2 for the glitch test.
OPS_A_DS32 = 80
# f64 operations a step (csrc/escape_f64.cu), at the card's f64 rate (132
# SMs x 64 lanes x the SM clock read under the dd64 loop), counted as
# OPS_A_F32 is, with the squares summed into |z|^2 counted once across steps
# (they are the next step's squares) and the loop head's test as the step's
# escape test.  Kernel A dd64, quadratic (quad_step and dist): the two Dekker
# splits 8; p1 = xh*xh and p2 = yh*yh 2 (dist's hi-word squares of the step
# before); the error terms e1, e2 7 each and p3 with e3 9; the low words l1,
# l2 3 each and l3 4; three two_sums 18; the real part's low sum 4 and
# fast_two_sum 3; the +-2 products 2; the imaginary part's low sum 2 and
# fast_two_sum 3: quad_step 75; |z|^2's add 1 and the escape test 1: 77 (a
# negated operand is the add's own modifier, not an op).  With periodicity
# a step that does not escape also runs diff_dist and its test: 10.  The
# f64 quadratic step: the two squares, the sub, +cr, zr*zi, *2, +ci, the
# sum into |z|^2 and the escape test: 9 (the count's add and the loop test
# are integer ops, not counted).
OPS_DD64 = 77
OPS_BRENT = 10
OPS_F64 = 9
# The grid loop on f32 words (escape_time_f32_grid and its colored form) does
# the same work, bounded as it is whatever implements it, at the f32 rate
# (PEAK_OPS): the redesigned loop carries the squares and tests once a pass,
# which the count of the function's work already assumes.
OPS_F32_GRID = OPS_F64
F64_LANES = 132 * 64
# kernel A f32, quadratic (csrc/escape.cu, step_sq and escape_pixel_f32's
# loop of two steps a pass): 8 a step for the step and |z|^2 together (zr*zr
# and zi*zi are the squares the step before summed into |z|^2, carried into
# the step: the two squares, the sub, +cr, zr*zi, *2, +ci, and the sum), 1
# for the escape test, and the loop counter's add and its test once a pass,
# 1 a step.  No count is kept a step: it is the loop counter at the exit.
OPS_A_F32 = 10
# kernel A's coloring epilogue (csrc/escape.cu color_pixel): a pixel |z|^2 3,
# the escape test 1, and a channel's mul, two selects, trunc, max, min and
# conversion 7 x 3; an escaped pixel also the count to float 1 and the
# exposure's div and mul 2, and with the smooth term sqrt, log2, /2, log2,
# 1 - nu and the add 6 more (each libdevice call counted as one operation).
OPS_A_COLOR = 25
OPS_A_ESCAPED = 3
OPS_A_SMOOTH = 6
OPS_B_DIST = 18
OPS_B_GLITCH = 20
# kernel D per loop step, counted from csrc/perturb_fe.cu's closed-domain
# ops (each add, sub, mul, compare, select, shift, and and or is one; bit
# casts are free): fe_add 20 (1 compare and 4 selects to order the operands,
# the gap, the shift on the exponent field in 2, the flush in 2, the add, and
# the renormalisation in 9), fe_mul 11 (the mul, the exponent add and the
# renormalisation), to_float 9; a step is 6 fe_add + 4 fe_mul + 1 neg + 2
# to_float (183), then Z_{n+1} + dz and |z|^2 (5), the glitch test (2), the
# loop test and the counters (5).  fe(2Z_n) is a row of the block's ring, made
# once a row, not a step.  Integer ops are counted at the f32 rate, which is
# twice the card's int32 rate, so the bound stays a lower one.
OPS_D = 195
# The fe BLA kernel's work (csrc/perturb_bla_fe.cu) in kernel D's units
# (fe_add 20, fe_mul 11, to_float 9; the kernel runs them where they give the
# general ops' bits, and floatexp.py's general ops, which take more, in the
# skip's products and wherever a value leaves the closed domain, so the bound
# stays a lower one): a plain step OPS_D;
# a skip a pixel, two complex products (4 fe_mul, 2 fe_add and a neg each:
# 85), the gain fold of the dc term 2, two fe_add 40, two to_float 18, Z + dz
# twice and the count 3: 235; a gate a pixel, |dz|^2 (2 fe_mul and an fe_add:
# 42), its key and max 4: 46.
OPS_BLA_SKIP = 235
OPS_BLA_GATE = 46
# Instructions on one step's critical path, counted from the sources (the
# dependent chain from one step's state to the next step's, each instruction
# one issue after the one it waits for; both loops take two steps a pass, so
# the exit test's tail is paid once a pass): kernel D 31 for the fe add, mul,
# add, add chain on dz a step plus 10 for to_float, z, |z|^2, the glitch and
# escape tests and the branch a pass; kernels B and C 4 for dz' (quadratic) a
# step plus 7 for z, |z|^2, the tests and the branch a pass; kernel A ds32 10
# for quad_step's real part (z.r.hi's square, which |z|^2 took in the step
# before, the sub and the second two_sum's low word 6, the low sum's last add,
# fast_two_sum's add) plus 3 for |z|^2's add, the test and the branch a step.
# Each waits ~4 cycles for the one before.
CRIT_D = 36
# The fe BLA kernel's phase (from the barrier that publishes a gate to the
# next one), counted as CRIT_D: the decision's ballot and shared store 5, the
# skip's fe_mul, fe_add, fe_add, to_float and Z + dz 28, the gate's fe_mul,
# fe_add and key 16, the block's reduction (5 shuffles and maxes, 7 maxes
# over the warps, the atomic) 20: 69; the phase of a macro step's last
# attempt adds its plain steps at CRIT_D each.  The barrier's own latency is
# not counted.
CRIT_BLA_PHASE = 69
CRIT_B = 7.5
CRIT_A_DS32 = 13
CYCLES_PER_DEPENDENT = 4
# kernel F as kernel B's dist-only form; kernel E as kernel B's glitch form
# plus the 2 that form 2 Z_n from the packed row (the kernel's loop head tests
# |z|^2 a second time, which the function does not need and the bound does
# not count); kernel G two operations per element-step.
OPS_E = OPS_B_GLITCH + 2
OPS_G = 2

HEADLINE = dict(algo="mandelbrot", width=3000, height=3000, iterations=4000,
                pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                exposure=5.0, inside=False)
# a centre of portbench's stills_around mix (mandel_1e6x.exact): within half
# a view of HEADLINE's, 0.3 view widths right and 0.4 view heights down
STILLS_CENTRE = ("-0.7436444860", "0.1318248536")
SEAHORSE = (-0.74364388703715871, 0.13182590420531198)
DZ1E12 = dict(width=3000, height=3000, iterations=4000, pos=SEAHORSE,
              scale=(1e12, 1e12), inside=False)                 # bench.py:227-231
P1E15 = dict(width=1920, height=1080, iterations=5000, pos=SEAHORSE,
             scale=(1e15, 1e15), inside=False)                  # bench.py:261-265
CJ3 = (0.44304637997136526, 0.558308536476846)
NEEDLE_X = "-1.999999999999999999999999999999999999999999991"
FE1E44 = dict(width=768, height=512, iterations=2000, pos_str=(NEEDLE_X, "0.0"),
              scale=(1e44, 1e44), inside=False)                 # bench.py:268-273
FE1E44_11K = {**FE1E44, "iterations": 11000}                    # bench.py:281-286
MINIBROT_1E40 = (                                               # bench.py:238-239
    "-157996253097964571301972830522288002021514947629178379711098185808257073039470695158211"
    "500112900838145522465809142611009023639565445383101084883134484682610353514940624481200"
    "762246007439/21246224954185596982356444388886765871850466714768369517916799937323069424"
    "12839334298948618382758177182520082138012408964391407755108195463125392196370432000000"
    "00000000000000000000000000",
    "280080281553491226689299320792460275443352487824755806050784911470162463798547283395645"
    "749202807599620687012818648641480112414162518702311032047517126075600434707761432252581"
    "05876903281/21246224954185596982356444388886765871850466714768369517916799937323069424128"
    "39334298948618382758177182520082138012408964391407755108195463125392196370432000000000000"
    "00000000000000000000")
BLA1E40 = dict(width=512, height=384, iterations=4000, pos_str=MINIBROT_1E40,
               scale=(1e40, 1e40), inside=False)                # bench.py:276-280
# a point of that minibrot's edge at the escape radius 2^16 and 4000
# iterations (bisected in 50-digit arithmetic along the real axis from its
# nucleus, tests/test_torch_bla_fe.py): at 1e31x every pixel escapes at step
# 3998 or 3999, after the fe BLA route's skips
BLA_EDGE = {**BLA1E40, "scale": (1e31, 1e31), "pos_str": (
    "-0.74364388703715193588250805698579195983784612807205961717200763389438822980422418",
    MINIBROT_1E40[1])}
JSWEEP = dict(algo="julia", width=1920, height=1080, iterations=300, pos=(0.0, 0.0),
              scale=(0.4, 0.4))                                 # bench.py:405-431
JSWEEP_FRAMES = 256
MID_SWEEP = dict(width=1920, height=1080, iterations=80,         # tests/test_animate.py:46-52
                 pos=(-0.7436447860, 0.1318252536), scale=(5e5, 5e5))
ZOOM_SWEEP = dict(width=1920, height=1080, iterations=4000, pos=SEAHORSE, scale=(1e12, 1e12),
                  inside=False)
MP100 = dict(width=10000, height=10000, iterations=500, exposure=5.0)  # bench.py:292-294
# phase 13's crop of fe1e44: width and height over this, the same spacing
FE_PLAIN_CROP = 8
# phase 28: a mid-zoom view where the f32 BLA route skips (the spiral at
# 1e13x, 240x135, 2000), and the pixels its image may differ on from kernel
# B's (tests/test_torch_bla.py::test_cpu_route_beside_the_card_route: 141
# of 32,400 in each tier, measured)
SPIRAL = (-0.7746806106269039, -0.1374168856037867)
F32_BLA_VIEW = dict(width=240, height=135, iterations=2000, pos=SPIRAL, scale=(1e13, 1e13))
F32_BLA_MISMATCH = 180
# bench.py's rows on kernel A's f32 form that no earlier phase renders
ROWS = {"julia_1080p": dict(algo="julia", width=1920, height=1080, iterations=300,  # :215-218
                            julia_set=(-0.8, 0.156), scale=(0.4, 0.4), pos=(0.0, 0.0)),
        "mb3_2k": dict(algo="multibrot", power=3, width=2000, height=2000,          # :223-226
                       iterations=300, pos=(0.0, 0.0), scale=(0.35, 0.35)),
        "bship_2k": dict(algo="burningship", width=2000, height=2000, iterations=500,  # :247-250
                         pos=(-0.45, -0.5), scale=(0.8, 0.8))}
# Kernel A's views a rule at 256x192 (f32, ds32), each with escaping and
# interior pixels: phase 4's and tests/test_torch_escape.py's.
A_VIEWS = {
    "mandelbrot": (dict(pos=(-0.6, 0.0)),
                   dict(pos=(-0.7436447860, 0.1318252536), scale=(5e5, 5e5))),
    "julia": (dict(algo="julia", julia_set=(-0.8, 0.156), scale=(0.6, 0.6)),
              dict(algo="julia", julia_set=(-0.8, 0.156), pos=(-1.1979166666666665, 0.15625),
                   scale=(2e4, 2e4))),
    "burningship": (dict(algo="burningship", pos=(-0.45, -0.5), scale=(0.8, 0.8)),
                    dict(algo="burningship", pos=(-1.62, -0.01), scale=(2e4, 2e4))),
    "tricorn": (dict(algo="tricorn", pos=(-0.3, 0.0)),
                dict(algo="tricorn", pos=(-0.3, 0.0), scale=(3.0, 3.0))),
    "multibrot 3": (dict(algo="multibrot", power=3),
                    dict(algo="multibrot", power=3, pos=(-0.5729166666666666, -0.3125),
                         scale=(2e2, 2e2))),
}
MP100_BAND = 512
# --backend jnp's main path in phase 26: mp100's view at 1080p
BACKEND_SHAPE = dict(width=1920, height=1080)
# the explicit precision="perturb" render above spacing 1e-13 whose flagged
# pixels go to kernel A's points form (tests/test_perturb.py:142-167's 1e8x
# view, larger)
FALLBACK_1E8 = dict(width=1024, height=768, iterations=2000, pos=(-0.7436447860, 0.1318252536),
                    scale=(1e8, 1e8), precision="perturb")
M4K_SS2 = dict(width=3840, height=2160, iterations=600, supersample=2,  # bench.py:219-222
               pos=(-0.743643, 0.131825), scale=(5000.0, 5000.0))
FERN_100M = dict(width=2000, height=2000, iterations=100_000_000)  # bench.py:251-253
FERN_10M = dict(width=750, height=500, iterations=10_000_000)      # bench.py:257-259
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bits_equal(a, b) -> bool:
    """Bit-pattern equality (NaN payloads included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return float(d.max())


def torch_sync():
    import torch

    torch.cuda.synchronize()


def sync_time(fn):
    torch_sync()
    t0 = time.perf_counter()
    out = fn()
    torch_sync()
    return out, time.perf_counter() - t0


def compare(label: str, k, p, record: dict, key: str, extra: str = "") -> None:
    """Require the kernel's outputs ``k`` bit-equal to the plain version's
    ``p``; fold their largest difference into ``record[key]``."""
    torch_sync()
    err = max(max_abs_err(a, b) for a, b in zip(k, p))
    record[key] = max(record[key], err)
    eq = all(bits_equal(a, b) for a, b in zip(k, p))
    print(f"{label}: bit-equal={eq} max_abs_err={err!r}{extra}", flush=True)
    check(eq, f"the kernel differs from its plain version: {label}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clear_caches(perturb) -> None:
    for name, val in vars(perturb).items():
        if name.endswith("_CACHE") and isinstance(val, dict):
            val.clear()


def zero_counters(escape_cuda, perturb_cuda) -> None:
    escape_cuda.LAUNCHES = escape_cuda.F32_LAUNCHES = escape_cuda.POINT_LAUNCHES = 0
    escape_cuda.COLOR_LAUNCHES = 0
    perturb_cuda.LAUNCHES = perturb_cuda.FULL_LAUNCHES = perturb_cuda.POINT_LAUNCHES = 0
    perturb_cuda.FE_FULL_LAUNCHES = perturb_cuda.FE_POINT_LAUNCHES = 0
    perturb_cuda.BLA_FE_LAUNCHES = perturb_cuda.BLA_FE_REGISTER_LAUNCHES = 0
    perturb_cuda.BLA_FE_STREAMING_LAUNCHES = 0


def counters(escape_cuda, perturb_cuda) -> dict:
    return {"escape_time": escape_cuda.LAUNCHES, "escape_time_f32": escape_cuda.F32_LAUNCHES,
            "escape_color": escape_cuda.COLOR_LAUNCHES,
            "escape_points": escape_cuda.POINT_LAUNCHES,
            "perturb_dist": perturb_cuda.LAUNCHES, "perturb_full": perturb_cuda.FULL_LAUNCHES,
            "perturb_points": perturb_cuda.POINT_LAUNCHES,
            "perturb_fe_full": perturb_cuda.FE_FULL_LAUNCHES,
            "perturb_fe_points": perturb_cuda.FE_POINT_LAUNCHES,
            "perturb_bla_fe": perturb_cuda.BLA_FE_LAUNCHES}


def pan_scene(Scene, base: dict, pixels: int):
    """``base`` moved ``pixels`` pixels in x, exactly (as rationals)."""
    step = Fraction(1) / (Fraction(base["height"]) * Fraction(float(base["scale"][0])))
    if "pos_str" in base:
        x, y = Fraction(base["pos_str"][0]), Fraction(base["pos_str"][1])
    else:
        x, y = Fraction(float(base["pos"][0])), Fraction(float(base["pos"][1]))
    return Scene(**{**base, "pos_str": (str(x + pixels * step), str(y))})


def b_steps(zr, zi, cnt, gl, n0: int, n_steps: int, limit: float) -> int:
    """Loop steps kernel B's full form ran (``divergence.pixel_steps``,
    summed)."""
    from fractal_tpu_torch.utils.divergence import pixel_steps

    return int(pixel_steps(zr, zi, cnt, gl, n0, n_steps, limit).sum())


def print_efficiency(label: str, steps) -> None:
    """Warp efficiency of a grid launch's per-pixel ``steps`` for the 32x1
    warps the kernels run and a compact 8x4 tile."""
    from fractal_tpu_torch.utils.divergence import TILES, warp_efficiency

    print(f"warp efficiency {label}: " + ", ".join(
        f"{tw}x{th} {warp_efficiency(steps, (tw, th))!r}" for tw, th in TILES), flush=True)


def sm_clock_mhz(busy) -> float:
    """The SM clock ``nvidia-smi`` reads while ``busy()``'s launches keep the
    card working."""
    busy()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch_sync()
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.split()[0])


def latency_floor(label: str, steps_max: int, crit: float, mhz: float, bound) -> float:
    """The least time one pixel's dependent chain takes: its steps x the
    instructions on a step's critical path x 4 cycles / the SM clock (ms);
    printed beside the ops bound."""
    ms = steps_max * crit * CYCLES_PER_DEPENDENT / (mhz * 1e3)
    print(f"{label} latency floor: longest pixel {steps_max} steps x {crit} instructions x "
          f"{CYCLES_PER_DEPENDENT} cycles / {mhz:.0f} MHz = {ms:.4f} ms (critical path "
          f"counted from the source); ops/bytes bound {bound[0]:.4f} ms by {bound[1]}",
          flush=True)
    return ms


def epilogue_ops(zr, zi, sc) -> int:
    """The coloring epilogue's operations over the pixels of kernel A's
    final (zr, zi): ``OPS_A_COLOR`` each, more where the pixel escaped."""
    escaped = int((zr * zr + zi * zi > float(sc.stable_limit)).sum())
    return zr.numel() * OPS_A_COLOR + escaped * (OPS_A_ESCAPED + OPS_A_SMOOTH * sc.smooth)


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_ms(fn, name: str, reps: int = 3):
    """The profiler's mean device time (ms) of the kernel ``name`` over
    ``reps`` calls of ``fn``; None, printed, where it recorded no such
    launch (the caller then reports CUDA events and says so)."""
    from fractal_tpu_torch.utils.timing import profile_warm

    _, busy, top = profile_warm(lambda: [fn() for _ in range(reps)], top=8)
    hits = [t / calls for kname, t, calls in top if name in kname]
    if hits:
        return hits[0]
    print(f"the profiler recorded no {name} launch (device busy {busy!r} ms; kernels "
          f"{[k[:60] for k, _, _ in top]})", flush=True)
    return None


def ms_and_source(dev, events: float):
    """A kernel row's (ms, ms_by): the profiler's device time where it
    recorded the launch, else the CUDA events' time."""
    return (events, "events") if dev is None else (dev, "profiler")


# ---------------------------------------------------------------------------
# Phase 3: the headline main path
# ---------------------------------------------------------------------------


def phase_headline(Scene, render, escape_cuda, perturb_cuda, card):
    """The headline in both tiers through ``render_u8``: cold, then 3 warm
    calls; the launch counters are zeroed just before and read just after."""
    import torch

    scenes = {"p32": Scene(**HEADLINE, precision="p32"), "exact (auto)": Scene(**HEADLINE)}
    zero_counters(escape_cuda, perturb_cuda)
    images = {}
    for tier, sc in scenes.items():
        img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
        warm = []
        for _ in range(3):
            img, dt = sync_time(lambda: render.render_u8(sc, DEVICE))
            warm.append(dt)
        images[tier] = img
        print(f"headline {tier} on {card}: cold {cold * 1e3:.3f} ms, warm "
              f"{', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
              f"{statistics.median(warm) * 1e3:.3f} ms", flush=True)
    launches = counters(escape_cuda, perturb_cuda)
    print(f"launch counters after the headline renders: {launches}", flush=True)
    check(launches["escape_time"] > 0 and launches["perturb_dist"] > 0,
          "a kernel of the headline path never launched")
    check(launches["escape_color"] == 4,  # the exact tier's cold and 3 warm renders
          "the exact headline did not take kernel A's colored form once a render")
    for tier, img in images.items():
        check(tuple(img.shape) == (HEADLINE["height"], HEADLINE["width"], 3)
              and img.dtype == torch.uint8,
              f"{tier}: image {tuple(img.shape)} {img.dtype}")
        check(len(torch.unique(img.reshape(-1, 3), dim=0)) > 16,
              f"{tier}: the image is nearly flat")
    black = {t: (img == 0).all(-1) for t, img in images.items()}
    agree = float((black["p32"] == black["exact (auto)"]).float().mean())
    print(f"p32 vs exact: interior classification agrees on {agree!r} of pixels",
          flush=True)
    check(agree >= 0.99, "p32 and exact tiers disagree on the interior")
    return scenes, images, launches


def headline_plain_route(scene, escape_cuda, perturb, perturb_cuda, render):
    """The headline path with each kernel replaced by its plain version."""
    if scene.precision == "p32":
        st = perturb.perturb_setup(scene, DEVICE)
        d, cnt = perturb_cuda.perturb_dist_plain(st.table, st.P, st.n_steps,
                                                 height=st.height, width=st.width,
                                                 algo=scene.algo, power=scene.power)
        return render._color_and_downsample_dist(scene, d, cnt)
    prec = render.resolve_precision(scene, DEVICE)
    check(prec == "ds32", f"auto resolved to {prec}, not ds32")
    params = escape_cuda.scene_params(scene, device=DEVICE)
    zr, zi, cnt = escape_cuda.iterate_whole(
        params, algo=scene.algo, power=scene.power, iterations=scene.iterations,
        precision=prec, height=scene.height, width=scene.width,
        periodicity=not scene.inside)
    return render._color_and_downsample(scene, zr, zi, cnt)


# ---------------------------------------------------------------------------
# Phase 4: every kernel against its plain version
# ---------------------------------------------------------------------------


def phase_kernel_a(Scene, escape_cuda, record):
    cases = [
        ("f32 CLI default view", Scene(width=2000, height=1000, iterations=50,
                                       pos=(-0.6, 0.0), exposure=5.0), "f32", False),
        ("f32 julia", Scene(algo="julia", width=1024, height=768, iterations=300,
                            julia_set=(-0.8, 0.156), scale=(0.6, 0.6)), "f32", False),
        ("f32 burningship", Scene(algo="burningship", width=1024, height=768,
                                  iterations=120, pos=(-0.45, -0.5),
                                  scale=(0.8, 0.8)), "f32", True),
        ("f32 multibrot d=3", Scene(algo="multibrot", power=3, width=768, height=512,
                                    iterations=200), "f32", False),
        ("ds32 @5e5 periodicity on", Scene(width=512, height=384, iterations=1000,
                                           pos=(-0.7436447860, 0.1318252536),
                                           scale=(5e5, 5e5)), "ds32", True),
        ("ds32 @5e5 periodicity off", Scene(width=512, height=384, iterations=1000,
                                            pos=(-0.7436447860, 0.1318252536),
                                            scale=(5e5, 5e5)), "ds32", False),
        ("ds32 tricorn", Scene(algo="tricorn", width=512, height=384, iterations=500,
                               pos=(0.37708333333333327, 0.46875),
                               scale=(2e4, 2e4)), "ds32", True),
    ]
    for label, sc, prec, per in cases:
        params = escape_cuda.scene_params(sc, device=DEVICE)
        kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations,
                  precision=prec, height=sc.height, width=sc.width, periodicity=per)
        k = escape_cuda.iterate_params(params, **kw)
        p = escape_cuda.iterate_whole(params, **kw)
        compare(f"kernel A {label}: {sc.width}x{sc.height}/{sc.iterations}", k, p,
                record, "escape_time", f" cnt range [{int(k[2].min())}, {int(k[2].max())}]")


def deep_views(Scene):
    """The δ-recurrences' deep views (tests/test_perturb.py:653-925), at
    ~512x384."""
    return {
        "dz1e12 512x384": Scene(**{**DZ1E12, "width": 512, "height": 384}),
        "burningship 1e14": Scene(algo="burningship", width=512, height=384,
                                  iterations=1500, inside=False, scale=(1e14, 1e14),
                                  pos_str=("-0.45", "-0.829977217668251374661143257379")),
        "tricorn needle 1e16": Scene(algo="tricorn", width=512, height=384,
                                     iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16)),
        "multibrot d=3 1e14": Scene(algo="multibrot", power=3, width=512, height=384,
                                    iterations=1500, inside=False, scale=(1e14, 1e14),
                                    pos_str=("0.443046379971365280901244412109",
                                             "0.558308536476846021719895522933")),
        "julia z^3 1e15": Scene(algo="julia", power=3, width=512, height=384,
                                iterations=2500, julia_set=CJ3, inside=False,
                                scale=(1e15, 1e15),
                                pos_str=("164820600322731/562949953421312",
                                         "445587455483899/1688849860263936")),
        "julia z^2 1e5": Scene(algo="julia", width=512, height=384, iterations=600,
                               julia_set=(-0.4, 0.6), scale=(1e5, 1e5),
                               pos=(0.10416666666666666, -0.9374999999999999),
                               precision="perturb"),
    }


def phase_kernel_b(Scene, perturb, perturb_cuda, record):
    """Kernel B in every form against its plain version, bit for bit."""
    dist_cases = [
        ("series skip @1e10", Scene(width=512, height=384, iterations=4000, pos=SEAHORSE,
                                    scale=(1e10, 1e10), exposure=5.0, inside=False,
                                    precision="p32"), True),
        ("headline view @1e6", Scene(**{**HEADLINE, "width": 512, "height": 384,
                                        "precision": "p32"}), False),
        ("julia @1e5", Scene(algo="julia", width=512, height=384, iterations=2000,
                             julia_set=(-0.4, 0.6),
                             pos=(0.10416666666666666, -0.9374999999999999),
                             scale=(1e5, 1e5), precision="p32"), False),
    ]
    dist_cases += [(label, sc, False) for label, sc in deep_views(Scene).items()
                   if sc.algo != "mandelbrot"]
    for label, sc, need_skip in dist_cases:
        st = perturb.perturb_setup(sc, DEVICE)
        n0 = int(st.P[8].item())
        check(not need_skip or n0 > 0, f"{label}: the series skip did not fire")
        kw = dict(height=st.height, width=st.width, algo=sc.algo, power=sc.power)
        k = perturb_cuda.perturb_dist(st.table, st.P, st.n_steps, **kw)
        p = perturb_cuda.perturb_dist_plain(st.table, st.P, st.n_steps, **kw)
        compare(f"kernel B dist-only {label}: {st.width}x{st.height}/{sc.iterations} "
                f"P[8]={n0} n_steps={st.n_steps}", k, p, record, "perturb_dist",
                f" cnt range [{int(k[1].min())}, {int(k[1].max())}]")

    # the loop's two-step passes from an odd series start, with n_steps - n0
    # even and odd (the single last step): exits on either step of a pass
    from fractal_tpu_torch.utils.divergence import pixel_steps

    sc = deep_views(Scene)["dz1e12 512x384"]
    st = perturb.perturb_setup(sc, DEVICE)
    P = st.P.clone()
    P[8] = float(int(P[8].item()) | 1)
    n_odd = st.n_steps - 1 + st.n_steps % 2
    for n_steps in (n_odd, n_odd - 1):
        kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
        k = perturb_cuda.perturb_full(st.table, st.gtol, P, n_steps, **kw)
        p = perturb_cuda.perturb_full_plain(st.table, st.gtol, P, n_steps, **kw)
        steps = pixel_steps(*k, int(P[8].item()), n_steps, float(sc.limit))
        left = (k[0].double() ** 2 + k[1].double() ** 2 > float(sc.limit) ** 2) | (k[3] != 0)
        firsts = int((left & (steps % 2 == 1)).sum())
        seconds = int((left & (steps % 2 == 0)).sum())
        compare(f"kernel B glitch dz1e12 512x384, P[8]={int(P[8].item())} n_steps={n_steps}",
                k, p, record, "perturb_full",
                f" exits on a pass's first step {firsts}, second {seconds}")
        check(firsts > 0 and seconds > 0, "the odd-start case left on one step of a pass only")
        kw = dict(height=st.height, width=st.width)
        compare(f"kernel B dist-only dz1e12 512x384, P[8]={int(P[8].item())} "
                f"n_steps={n_steps}", perturb_cuda.perturb_dist(st.table, P, n_steps, **kw),
                perturb_cuda.perturb_dist_plain(st.table, P, n_steps, **kw), record,
                "perturb_dist")

    for label, sc in deep_views(Scene).items():
        st = perturb.perturb_setup(sc, DEVICE)
        for glitch in (True, False):
            kw = dict(iterations=sc.iterations, height=st.height, width=st.width,
                      algo=sc.algo, power=sc.power, glitch=glitch)
            k = perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps, **kw)
            p = perturb_cuda.perturb_full_plain(st.table, st.gtol, st.P, st.n_steps, **kw)
            compare(f"kernel B {'glitch' if glitch else 'full'} {label}: "
                    f"P[8]={int(st.P[8].item())} n_steps={st.n_steps}", k, p, record,
                    "perturb_full", f" cnt range [{int(k[2].min())}, {int(k[2].max())}],"
                    f" flagged {int(k[3].sum())}")


def forced_bad_reference(Scene, perturb, perturb_cuda):
    """The 1e16x needle at 256x192 / 300 with the reference forced to pixel
    (0, 0), whose orbit escapes early: (scene, gl, kernel outputs)."""
    sc = Scene(width=256, height=192, iterations=300, pos=(-2.0, 0.0), scale=(1e16, 1e16))
    w, h = sc.width, sc.height
    orbit = perturb.reference_orbit(sc, (0, 0), w, h)
    P = perturb._pert_params(sc, (0, 0), w, h, device=DEVICE)
    table, gtol = perturb._orbit_tensors(orbit, DEVICE)
    return sc, (table, gtol, P, orbit.n_steps)


def phase_bad_reference_and_points(Scene, perturb, perturb_cuda, escape_cuda, record):
    """Kernel B's glitch form against a forced bad reference (flags > 0),
    kernel C on the flagged list against the first secondary orbit, and
    kernel A's points form, each against its plain version."""
    import torch

    sc, (table, gtol, P, n_steps) = forced_bad_reference(Scene, perturb, perturb_cuda)
    w, h = sc.width, sc.height
    kw = dict(iterations=sc.iterations, height=h, width=w)
    k = perturb_cuda.perturb_full(table, gtol, P, n_steps, **kw)
    p = perturb_cuda.perturb_full_plain(table, gtol, P, n_steps, **kw)
    n_flag = int(k[3].sum())
    compare(f"kernel B glitch, needle @1e16 256x192/300, reference (0, 0) "
            f"(n_steps={n_steps})", k, p, record, "perturb_full", f" flagged {n_flag}")
    check(n_flag > 0, "the forced bad reference flagged no pixel")

    idx = torch.nonzero(k[3].reshape(-1)).squeeze(1).cpu().numpy()
    xs, ys = (idx % w).astype("float32"), (idx // w).astype("float32")
    d2 = (xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2
    ref = (int(xs[d2.argmin()]), int(ys[d2.argmin()]))
    orbit2 = perturb.reference_orbit(sc, ref, w, h)
    P2 = perturb._pert_params(sc, ref, w, h, device=DEVICE)
    table2, gtol2 = perturb._orbit_tensors(orbit2, DEVICE)
    xs_d = torch.from_numpy(xs).to(DEVICE)
    ys_d = torch.from_numpy(ys).to(DEVICE)
    ckw = dict(iterations=sc.iterations, algo=sc.algo, power=sc.power)
    k = perturb_cuda.perturb_points(table2, gtol2, P2, orbit2.n_steps, xs_d, ys_d, **ckw)
    p = perturb_cuda.perturb_points_plain(table2, gtol2, P2, orbit2.n_steps, xs_d, ys_d, **ckw)
    compare(f"kernel C, {idx.size} flagged pixels against the medoid {ref}", k, p, record,
            "perturb_points", f" resolved {int((k[3] == 0).sum())}")

    for label, s2 in (("ds32 @1e8", Scene(width=512, height=384, iterations=2000,
                                          pos=(-0.7436447860, 0.1318252536),
                                          scale=(1e8, 1e8))),
                      ("ds32 burningship", Scene(algo="burningship", width=512, height=384,
                                                 iterations=60, pos=(-1.62, -0.01),
                                                 scale=(2e4, 2e4)))):
        params = escape_cuda.scene_params(s2, device=DEVICE)
        gen = torch.Generator().manual_seed(5)
        pick = torch.randperm(s2.width * s2.height, generator=gen)[:4096].to(DEVICE)
        pxs = (pick % s2.width).float()
        pys = (pick // s2.width).float()
        akw = dict(algo=s2.algo, power=s2.power, iterations=s2.iterations, precision="ds32")
        k = escape_cuda.iterate_points(params, pxs, pys, **akw)
        p = escape_cuda.iterate_points_plain(params, pxs, pys, **akw)
        compare(f"kernel A points {label}, 4096 pixels", k, p, record, "escape_points")
        grid = escape_cuda.iterate_params(params, height=s2.height, width=s2.width, **akw)
        same = all(bits_equal(a, g.reshape(-1)[pick]) for a, g in zip(k, grid))
        print(f"kernel A points {label} == kernel A grid at the same pixels: {same}",
              flush=True)
        check(same, f"kernel A's points form differs from its grid form: {label}")


def sample_pixels(width: int, height: int, k: int, seed: int):
    """k distinct pixels of a (height, width) grid, seeded: (xs, ys) f32 on
    the card."""
    import torch

    pick = torch.randperm(width * height, generator=torch.Generator().manual_seed(seed))[:k]
    return (pick % width).float().to(DEVICE), (pick // width).float().to(DEVICE)


def c_plan(perturb_cuda, _cuda_build, n_steps: int, k: int, glitch: bool = True) -> str:
    chunk, nbuf = perturb_cuda.points_plan(n_steps, k, glitch, _cuda_build.smem_limits(DEVICE),
                                           perturb_cuda.points_layout())
    return "whole table" if nbuf == 1 else f"ring of {chunk}-row chunks"


def phase_kernel_c(Scene, perturb, perturb_cuda, _cuda_build, record):
    """Kernel C's own loop against its plain version, bit for bit: a list of
    4,096 pixels of every rule's view with the glitch test on and off, and
    dz1e12's view from an odd series start with n_steps − n0 even and odd."""
    for label, sc in deep_views(Scene).items():
        st = perturb.perturb_setup(sc, DEVICE)
        xs, ys = sample_pixels(st.width, st.height, 4096, 11)
        for glitch in (True, False):
            kw = dict(iterations=sc.iterations, algo=sc.algo, power=sc.power, glitch=glitch)
            k = perturb_cuda.perturb_points(st.table, st.gtol, st.P, st.n_steps, xs, ys, **kw)
            p = perturb_cuda.perturb_points_plain(st.table, st.gtol, st.P, st.n_steps, xs, ys,
                                                  **kw)
            compare(f"kernel C {'glitch' if glitch else 'full'} {label}, 4096 px (P[8]="
                    f"{int(st.P[8].item())}, n_steps {st.n_steps}, "
                    f"{c_plan(perturb_cuda, _cuda_build, st.n_steps, 4096, glitch)})", k, p,
                    record, "perturb_points",
                    f" cnt range [{int(k[2].min())}, {int(k[2].max())}], flagged {int(k[3].sum())}")
    sc = deep_views(Scene)["dz1e12 512x384"]
    st = perturb.perturb_setup(sc, DEVICE)
    P = st.P.clone()
    P[8] = float(int(P[8].item()) | 1)
    xs, ys = sample_pixels(st.width, st.height, 4096, 12)
    n_odd = st.n_steps - 1 + st.n_steps % 2
    for n_steps in (n_odd, n_odd - 1):
        kw = dict(iterations=sc.iterations)
        compare(f"kernel C glitch dz1e12 512x384, 4096 px, P[8]={int(P[8].item())} "
                f"n_steps={n_steps}",
                perturb_cuda.perturb_points(st.table, st.gtol, P, n_steps, xs, ys, **kw),
                perturb_cuda.perturb_points_plain(st.table, st.gtol, P, n_steps, xs, ys, **kw),
                record, "perturb_points")


def phase_long_budget(Scene, perturb, perturb_cuda, _cuda_build, record, card):
    """Kernel B's glitch form at 20,000 iterations (the reference's stream
    form) against its plain version."""
    sc = Scene(width=768, height=512, iterations=20000, pos=SEAHORSE, scale=(1e15, 1e15),
               inside=False)
    st = perturb.perturb_setup(sc, DEVICE)
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    (k, t_k) = sync_time(lambda: perturb_cuda.perturb_full(st.table, st.gtol, st.P,
                                                           st.n_steps, **kw))
    (p, t_p) = sync_time(lambda: perturb_cuda.perturb_full_plain(st.table, st.gtol, st.P,
                                                                 st.n_steps, **kw))
    compare(f"kernel B glitch 768x512 @1e15 / 20000 (P[8]={int(st.P[8].item())}, "
            f"n_steps={st.n_steps}, {st.table.shape[0]} rows) on {card}: kernel "
            f"{t_k * 1e3:.3f} ms, plain {t_p * 1e3:.3f} ms", k, p, record, "perturb_full",
            f" cnt range [{int(k[2].min())}, {int(k[2].max())}]")
    # kernel C against the same orbit: the table outgrows a block's shared
    # memory, so the rows stream through the ring
    xs, ys = sample_pixels(st.width, st.height, 8192, 13)
    plan = c_plan(perturb_cuda, _cuda_build, st.n_steps, xs.numel())
    check(plan.startswith("ring"), f"20,000 iterations: kernel C took the {plan}")
    ckw = dict(iterations=sc.iterations)
    (k, t_k) = sync_time(lambda: perturb_cuda.perturb_points(st.table, st.gtol, st.P,
                                                             st.n_steps, xs, ys, **ckw))
    p = perturb_cuda.perturb_points_plain(st.table, st.gtol, st.P, st.n_steps, xs, ys, **ckw)
    compare(f"kernel C 768x512 @1e15 / 20000, 8192 px ({plan}) on {card}: kernel "
            f"{t_k * 1e3:.3f} ms", k, p, record, "perturb_points",
            f" cnt range [{int(k[2].min())}, {int(k[2].max())}]")


# ---------------------------------------------------------------------------
# Phase 6-8: the deep path
# ---------------------------------------------------------------------------


def print_split(label: str, split, details: bool = True) -> None:
    groups = {}
    for kind, _, ms in split:
        n, t = groups.get(kind, (0, 0.0))
        groups[kind] = (n + 1, t + ms)
    # "reference" encloses the walk and the probe: the total counts each step once
    total = sum(ms for kind, _, ms in split if kind != "reference")
    print(f"{label} cold split, {total:.3f} ms in all: "
          + "; ".join(f"{kind} x{n} {t:.3f} ms" for kind, (n, t) in groups.items()),
          flush=True)
    for kind, detail, ms in split if details else ():
        print(f"    {kind:>16s} {ms:10.3f} ms  {detail}", flush=True)


def phase_deep(Scene, render, perturb, native_walk, card,
               views=(("dz1e12", DZ1E12), ("p1e15", P1E15)), tier="perturb",
               route="cuda kernels"):
    """``views`` (dz1e12 and p1e15, or the floatexp views) through
    ``render_u8(scene, "cuda")``: cold (split), warm, pan, with the tier and
    main-grid route required.  Returns {name: (scene, cold image, stats, the
    first multiref reference's (table, gtol, P, n_steps) or None)}."""
    from fractal_tpu_torch.utils.timing import Fenced

    out = {}
    for name, base in views:
        sc = Scene(**base)
        check(render.resolve_precision(sc, DEVICE) == "perturb",
              f"{name}: auto did not resolve to perturb")
        clear_caches(perturb)
        walks = dict(native_walk.WALKS)
        mp_before = dict(perturb.MPMATH_WALKS)
        perturb.SPLIT = Fenced()
        img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
        split, perturb.SPLIT = perturb.SPLIT, None
        stats = dict(perturb.RENDER_STATS)
        print(f"{name} on {card}: cold {cold * 1e3:.3f} ms (fenced), RENDER_STATS {stats}; "
              f"native walks {native_walk.WALKS['walk'] - walks['walk']} orbits + "
              f"{native_walk.WALKS['direct'] - walks['direct']} direct pixels, mpmath "
              f"loops {perturb.MPMATH_WALKS['walk'] - mp_before['walk']} + "
              f"{perturb.MPMATH_WALKS['direct'] - mp_before['direct']}", flush=True)
        print_split(name, split)
        pack = perturb._MULTIREF_CACHE.get(perturb._orbit_key(sc, ("multiref",), sc.width,
                                                              sc.height))
        check(stats["tier"] == tier, f"{name}: tier {stats['tier']}")
        check(stats["route"] == route, f"{name}: route {stats['route']}")
        check(int(stats["n_residual"]) == 0, f"{name}: {stats['n_residual']} unresolved")
        check(tuple(img.shape) == (sc.height, sc.width, 3), f"{name}: shape")
        warm = []
        for _ in range(3):
            img2, dt = sync_time(lambda: render.render_u8(sc, DEVICE))
            warm.append(dt)
            check(int(perturb.RENDER_STATS["n_residual"]) == 0, f"{name}: warm residual")
            check(bits_equal(img2, img), f"{name}: a warm frame differs from the cold one")
        print(f"{name} on {card}: warm {', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, "
              f"p50 {statistics.median(warm) * 1e3:.3f} ms, equal to cold", flush=True)
        pan = pan_scene(Scene, base, 7)
        walks = dict(native_walk.WALKS)
        pimg, t_pan = sync_time(lambda: render.render_u8(pan, DEVICE))
        pstats = dict(perturb.RENDER_STATS)
        print(f"{name} 7-pixel pan on {card}: {t_pan * 1e3:.3f} ms, RENDER_STATS {pstats}, "
              f"new native walks {native_walk.WALKS['walk'] - walks['walk']}", flush=True)
        check(int(pstats["n_residual"]) == 0, f"{name} pan: unresolved pixels")
        check(tuple(pimg.shape) == tuple(img.shape), f"{name} pan: shape")
        out[name] = (sc, img, stats, pack[0] if pack else None)
    return out


def phase_deep_plain(perturb, deep, card, names):
    """The same orchestration with the plain versions on the card, cold."""
    for name in names:
        sc, img, stats, _ = deep[name]
        clear_caches(perturb)
        p_img, t_plain = sync_time(lambda: perturb.render_exact(sc, DEVICE, perturb.PLAIN))
        pstats = dict(perturb.RENDER_STATS)
        eq = bits_equal(p_img, img)
        print(f"{name} plain route on {card}: {t_plain * 1e3:.3f} ms, RENDER_STATS {pstats}; "
              f"image == kernel route's: {eq}", flush=True)
        check(pstats["route"] == "plain", f"{name}: the plain route took {pstats['route']}")
        check(eq, f"{name}: the plain route's image differs from the kernel route's")
        for key in ("n_glitch", "n_residual", "multiref_rounds", "n_direct"):
            check(int(pstats[key]) == int(stats[key]), f"{name}: {key} differs")


def phase_plain_crop(Scene, render, perturb, card, name: str, base: dict, div: int):
    """``phase_deep_plain`` at a centred crop of ``base`` (its width and
    height over ``div``, the same pixel spacing), against the kernel
    route's cold render of the crop."""
    t0 = time.perf_counter()
    sc = Scene(**{**base, "width": base["width"] // div, "height": base["height"] // div,
                  "scale": tuple(s * div for s in base["scale"])})
    label = f"{name} {sc.width}x{sc.height} crop"
    clear_caches(perturb)
    img, t_kernel = sync_time(lambda: render.render_u8(sc, DEVICE))
    stats = dict(perturb.RENDER_STATS)
    print(f"{label} on {card}: kernel route cold {t_kernel * 1e3:.3f} ms, RENDER_STATS "
          f"{stats}", flush=True)
    check(stats["route"] == "kernel D" and int(stats["n_glitch"]) > 0
          and int(stats["multiref_rounds"]) > 0,
          f"{label}: not kernel D's route with multiref rounds: {stats}")
    phase_deep_plain(perturb, {label: (sc, img, stats, None)}, card, [label])
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)


def phase_ds32_fallback(Scene, render, perturb, perturb_cuda, escape_cuda, card):
    """An explicit precision="perturb" render above spacing 1e-13, whose
    flagged pixels go to kernel A's points form (tests/test_perturb.py:
    142-167's 1e8x view, larger).  Returns (launches, the points call)."""
    import torch

    sc = Scene(**FALLBACK_1E8)
    clear_caches(perturb)
    zero_counters(escape_cuda, perturb_cuda)
    img, t = sync_time(lambda: render.render_u8(sc, DEVICE))
    stats = dict(perturb.RENDER_STATS)
    fed = None
    if stats["n_glitch"] == 0:
        # no flag on this view: feed _apply_fallback kernel B's glitch form
        # against a forced bad reference, pixel (0, 0)
        w, h = sc.width, sc.height
        orbit = perturb.reference_orbit(sc, (0, 0), w, h)
        P = perturb._pert_params(sc, (0, 0), w, h, device=DEVICE)
        table, gtol = perturb._orbit_tensors(orbit, DEVICE)
        zr, zi, cnt, gl = perturb_cuda.perturb_full(table, gtol, P, orbit.n_steps,
                                                    iterations=sc.iterations, height=h,
                                                    width=w)
        fzr, fzi, fcnt, n = perturb._apply_fallback(sc, zr, zi, cnt, gl, w, h, DEVICE)
        fed = (gl, fcnt)
        print(f"1e8 view flagged no pixel; forced reference (0, 0) (n_steps "
              f"{orbit.n_steps}) flagged {n}", flush=True)
    launches = counters(escape_cuda, perturb_cuda)
    print(f"ds32 fallback 1024x768 @1e8 / 2000 on {card}: {t * 1e3:.3f} ms, RENDER_STATS "
          f"{stats}; launch counters {launches}", flush=True)
    check(launches["escape_points"] > 0, "kernel A's points form never launched")
    if fed is not None:
        gl, fcnt = fed
        params = escape_cuda.scene_params(sc, device=DEVICE)
        grid = escape_cuda.iterate_params(params, algo=sc.algo, power=sc.power,
                                          iterations=sc.iterations, precision="ds32",
                                          height=sc.height, width=sc.width)[2]
        m = gl != 0
        check(bool(torch.equal(fcnt[m], grid[m])),
              "the ds32 fallback's counts differ from kernel A's grid counts")
        print("ds32 fallback counts == kernel A ds32 grid counts on the flagged pixels",
              flush=True)
    return sc, launches


# ---------------------------------------------------------------------------
# Phase 9: deep-path kernels at their main-path shapes
# ---------------------------------------------------------------------------


def phase_deep_timing(Scene, perturb, perturb_cuda, escape_cuda, _cuda_build, fallback_scene,
                      deep, record, card):
    """Each deep-path kernel at the shape the main path gives it, against its
    plain version: kernel B's glitch form over dz1e12, kernel C over its
    flagged list against the first multiref reference, kernel A's points
    form over the 1e8 view's flagged list."""
    import torch

    from fractal_tpu_torch.utils.timing import event_ms

    rec = {}
    sc = Scene(**DZ1E12)
    clear_caches(perturb)
    st = perturb.perturb_setup(sc, DEVICE)
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    ms, k = event_ms(lambda: perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps,
                                                       **kw))
    p, t_plain = sync_time(lambda: perturb_cuda.perturb_full_plain(st.table, st.gtol, st.P,
                                                                   st.n_steps, **kw))
    compare(f"kernel B glitch dz1e12 3000x3000/4000 (P[8]={int(st.P[8].item())}) on "
            f"{card}: {ms:.3f} ms, plain {t_plain * 1e3:.3f} ms", k, p, record, "perturb_full")
    n0 = int(st.P[8].item())
    steps = b_steps(*k, n0, st.n_steps, float(sc.limit))
    nbytes = st.table.numel() * 4 + st.gtol.numel() * 4 + 64 + st.height * st.width * 16
    rec["perturb_full"] = (ms, t_plain * 1e3, *bound_ms(steps * OPS_B_GLITCH, nbytes))
    print(f"kernel B glitch dz1e12: {steps} pixel-steps in {ms:.3f} ms = "
          f"{steps / ms / 1e6:.2f} G steps/s", flush=True)
    from fractal_tpu_torch.utils.divergence import pixel_steps

    print_efficiency("kernel B glitch dz1e12", pixel_steps(*k, n0, st.n_steps, float(sc.limit)))
    mhz = sm_clock_mhz(lambda: [perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps,
                                                          **kw) for _ in range(30)])
    print(f"SM clock under load on {card}: {mhz:.0f} MHz", flush=True)
    rec["sm_clock_mhz"] = mhz

    # kernel C as the cold frame's first round launches it: every flagged
    # pixel against the first reference that resolved pixels there
    idx = torch.nonzero(k[3].reshape(-1)).squeeze(1)
    table, gtol, P, n_steps = deep["dz1e12"][3]
    xs = (idx % st.width).float()
    ys = (idx // st.width).float()
    ckw = dict(iterations=sc.iterations, algo=sc.algo, power=sc.power)
    ms, k = event_ms(lambda: perturb_cuda.perturb_points(table, gtol, P, n_steps,
                                                         xs, ys, **ckw))
    p, t_plain = sync_time(lambda: perturb_cuda.perturb_points_plain(
        table, gtol, P, n_steps, xs, ys, **ckw))
    plan = c_plan(perturb_cuda, _cuda_build, n_steps, idx.numel())
    compare(f"kernel C dz1e12 flagged list ({idx.numel()} px) against its "
            f"first multiref reference on {card}: {ms:.3f} ms, plain "
            f"{t_plain * 1e3:.3f} ms", k, p, record, "perturb_points")
    n0 = int(P[8].item())
    per_px = pixel_steps(*k, n0, n_steps, float(sc.limit))
    nbytes = table.numel() * 4 + gtol.numel() * 4 + 64 + idx.numel() * (8 + 16)
    rec["perturb_points"] = (ms, t_plain * 1e3,
                             *bound_ms(int(per_px.sum()) * OPS_B_GLITCH, nbytes))
    steps_max = int(per_px.max())
    rec["perturb_points_floor"] = latency_floor("kernel C", steps_max, CRIT_B, mhz,
                                                rec["perturb_points"][2:])
    # the measured floor: the list's longest pixel alone, one thread
    top = int(per_px.argmax())
    ms1, k1 = event_ms(lambda: perturb_cuda.perturb_points(table, gtol, P, n_steps,
                                                           xs[top:top + 1], ys[top:top + 1],
                                                           **ckw))
    check(all(bits_equal(a, b[top:top + 1]) for a, b in zip(k1, k)),
          "kernel C on one pixel differs from the same pixel in its list")
    rec["perturb_points_one_pixel"] = ms1
    threads, ahead = perturb_cuda.points_layout()
    blocks = -(-idx.numel() // threads)
    print(f"kernel C plan: {plan} ({(n_steps + ahead) * 12} B), "
          f"{threads}-thread blocks (one warp a scheduler of an SM): "
          f"{blocks} blocks on {_cuda_build.smem_limits(DEVICE)[2]} SMs", flush=True)
    where = "the chain" if ms < 1.5 * ms1 else "contention among the list's warps"
    print(f"kernel C measured floor on {card}: the longest pixel ({steps_max} steps from n0 "
          f"{n0}) alone {ms1:.4f} ms = {ms1 * 1e3 * mhz / steps_max:.1f} cycles a step; the "
          f"list {ms:.4f} ms = {ms * 1e3 * mhz / steps_max:.1f} cycles a step, {ms / ms1:.2f}x "
          f"it; counted floor {rec['perturb_points_floor']:.4f} ms: the time is on {where}",
          flush=True)
    # p1e15's first list, as its cold frame's round launches it
    s15 = Scene(**P1E15)
    clear_caches(perturb)
    st15 = perturb.perturb_setup(s15, DEVICE)
    gl15 = perturb_cuda.perturb_full(st15.table, st15.gtol, st15.P, st15.n_steps,
                                     iterations=s15.iterations, height=st15.height,
                                     width=st15.width)[3]
    idx15 = torch.nonzero(gl15.reshape(-1)).squeeze(1)
    if deep["p1e15"][3] is not None and idx15.numel() > 0:
        t15, g15, P15, ns15 = deep["p1e15"][3]
        x15, y15 = (idx15 % st15.width).float(), (idx15 // st15.width).float()
        ckw15 = dict(iterations=s15.iterations)
        ms15, k15 = event_ms(lambda: perturb_cuda.perturb_points(t15, g15, P15, ns15, x15, y15,
                                                                 **ckw15))
        compare(f"kernel C p1e15 flagged list ({idx15.numel()} px) against its first "
                f"multiref reference on {card}: {ms15:.4f} ms", k15,
                perturb_cuda.perturb_points_plain(t15, g15, P15, ns15, x15, y15, **ckw15),
                record, "perturb_points")

    # kernel B's glitch form at p1e15: its warp efficiency
    s15 = Scene(**P1E15)
    st15 = perturb.perturb_setup(s15, DEVICE)
    k15 = perturb_cuda.perturb_full(st15.table, st15.gtol, st15.P, st15.n_steps,
                                    iterations=s15.iterations, height=st15.height,
                                    width=st15.width)
    print_efficiency("kernel B glitch p1e15", pixel_steps(*k15, int(st15.P[8].item()),
                                                          st15.n_steps, float(s15.limit)))

    # kernel A's points form over the flagged list of the 1e8 render
    fs, params, xs, ys, akw = a_points_case(fallback_scene, perturb, perturb_cuda, escape_cuda)
    ms, k = event_ms(lambda: escape_cuda.iterate_points(params, xs, ys, **akw))
    p, t_plain = sync_time(lambda: escape_cuda.iterate_points_plain(params, xs, ys, **akw))
    compare(f"kernel A points, 1e8 flagged list ({xs.numel()} px) on {card}: "
            f"{ms:.3f} ms, plain {t_plain * 1e3:.3f} ms", k, p, record, "escape_points")
    cnt = k[2].long()
    per_px = cnt + (cnt < fs.iterations).long()
    rec["escape_points"] = (ms, t_plain * 1e3,
                            *bound_ms(int(per_px.sum()) * OPS_A_DS32, 64 + xs.numel() * (8 + 12)))
    rec["escape_points_floor"] = latency_floor("kernel A points", int(per_px.max()), CRIT_A_DS32,
                                               mhz, rec["escape_points"][2:])
    return rec


def a_points_case(fs, perturb, perturb_cuda, escape_cuda):
    """Kernel A's points form as the render of ``fs`` (``FALLBACK_1E8``)
    launches it: over the pixels kernel B's glitch form flags there (or,
    where the view flags nothing, against a forced reference at pixel (0,
    0)).  Returns (fs, params, xs, ys, keywords)."""
    import torch

    clear_caches(perturb)
    w, h = fs.width, fs.height
    st = perturb.perturb_setup(fs, DEVICE)
    gl = perturb_cuda.perturb_full(st.table, st.gtol, st.P, st.n_steps,
                                   iterations=fs.iterations, height=h, width=w)[3]
    if int(gl.sum()) == 0:
        orbit = perturb.reference_orbit(fs, (0, 0), w, h)
        P = perturb._pert_params(fs, (0, 0), w, h, device=DEVICE)
        table, gtol = perturb._orbit_tensors(orbit, DEVICE)
        gl = perturb_cuda.perturb_full(table, gtol, P, orbit.n_steps,
                                       iterations=fs.iterations, height=h, width=w)[3]
    idx = torch.nonzero(gl.reshape(-1)).squeeze(1)
    params = escape_cuda.scene_params(fs, h, w, device=DEVICE)
    akw = dict(algo=fs.algo, power=fs.power, iterations=fs.iterations, precision="ds32")
    return fs, params, (idx % w).float(), (idx // w).float(), akw


# ---------------------------------------------------------------------------
# Phases 10-14: the floatexp tier past 1e30x
# ---------------------------------------------------------------------------


def phase_kernel_d(Scene, perturb, perturb_cuda, record, card):
    """Kernel D against its plain version, bit for bit: the grid form with
    glitch on and off (fe1e44; julia c = -2 at 1e35x, whose real axis is
    the Julia set), the points form over the flagged list of a forced bad
    reference at fe1e44, and fe1e44_11k at 11,000 iterations."""
    import torch

    cases = [("fe1e44", Scene(**FE1E44)),
             ("julia c=-2 @1e35", Scene(algo="julia", width=512, height=384, iterations=600,
                                        julia_set=(-2.0, 0.0), pos_str=("0.5", "0"),
                                        scale=(1e35, 1e35)))]
    for label, sc in cases:
        st = perturb.perturb_setup(sc, DEVICE)
        check(st.extreme and st.bla is None, f"{label}: not on kernel D's route")
        for glitch in (True, False):
            kw = dict(iterations=sc.iterations, height=st.height, width=st.width,
                      algo=sc.algo, glitch=glitch)
            k, t_k = sync_time(lambda: perturb_cuda.perturb_fe_full(
                st.table, st.gtol, st.P, st.n_steps, **kw))
            p, t_p = sync_time(lambda: perturb_cuda.perturb_fe_full_plain(
                st.table, st.gtol, st.P, st.n_steps, **kw))
            compare(f"kernel D {'glitch' if glitch else 'full'} {label} "
                    f"{st.width}x{st.height}/{sc.iterations} (n_steps {st.n_steps}) on {card}: "
                    f"kernel {t_k * 1e3:.3f} ms, plain {t_p * 1e3:.3f} ms", k, p, record,
                    "perturb_fe_full", f" cnt range [{int(k[2].min())}, {int(k[2].max())}],"
                    f" flagged {int(k[3].sum())}")

    sc = Scene(**FE1E44)
    w, h = sc.width, sc.height
    orbit0 = perturb.reference_orbit(sc, (0, 0), w, h)
    P0 = perturb._pert_params_fe(sc, (0, 0), w, h, device=DEVICE)
    table0, gtol0 = perturb._orbit_tensors(orbit0, DEVICE)
    gl = perturb_cuda.perturb_fe_full(table0, gtol0, P0, orbit0.n_steps,
                                      iterations=sc.iterations, height=h, width=w)[3]
    idx = torch.nonzero(gl.reshape(-1)).squeeze(1)
    check(idx.numel() > 0, "the forced bad reference flagged no pixel at fe1e44")
    st = perturb.perturb_setup(sc, DEVICE)
    xs, ys = (idx % w).float(), (idx // w).float()
    kw = dict(iterations=sc.iterations)
    k = perturb_cuda.perturb_fe_points(st.table, st.gtol, st.P, st.n_steps, xs, ys, **kw)
    p = perturb_cuda.perturb_fe_points_plain(st.table, st.gtol, st.P, st.n_steps, xs, ys,
                                             **kw)
    compare(f"kernel D points, fe1e44: the {idx.numel()} pixels reference (0, 0) "
            f"(n_steps {orbit0.n_steps}) flagged, against the view's reference "
            f"{st.ref_px}", k, p, record, "perturb_fe_points",
            f" resolved {int((k[3] == 0).sum())}")

    sc = Scene(**FE1E44_11K)
    st = perturb.perturb_setup(sc, DEVICE)
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    k, t_k = sync_time(lambda: perturb_cuda.perturb_fe_full(st.table, st.gtol, st.P,
                                                            st.n_steps, **kw))
    p, t_p = sync_time(lambda: perturb_cuda.perturb_fe_full_plain(st.table, st.gtol, st.P,
                                                                  st.n_steps, **kw))
    compare(f"kernel D glitch fe1e44_11k {st.width}x{st.height}/{sc.iterations} (n_steps "
            f"{st.n_steps}, {st.table.shape[0]} rows) on {card}: kernel {t_k * 1e3:.3f} ms, "
            f"plain {t_p * 1e3:.3f} ms", k, p, record, "perturb_fe_full",
            f" cnt range [{int(k[2].min())}, {int(k[2].max())}]")


def phase_bla_and_p32(Scene, render, perturb, perturb_cuda, escape_cuda, card):
    """bla1e40 through the fe BLA kernel (cold with its split, 3 warm calls
    equal to it, one launch a render: the counter zeroed before, read
    after), and fe1e44 in p32 through kernel D's grid form without the
    glitch test (its counter zeroed before, read after).  → (the fe BLA
    kernel's launches, bla1e40's image)."""
    from fractal_tpu_torch.utils.timing import Fenced

    sc = Scene(**BLA1E40)
    check(render.resolve_precision(sc, DEVICE) == "perturb", "bla1e40: not perturb")
    clear_caches(perturb)
    perturb.SPLIT = Fenced()
    zero_counters(escape_cuda, perturb_cuda)
    img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
    split, perturb.SPLIT = perturb.SPLIT, None
    stats = dict(perturb.RENDER_STATS)
    print(f"bla1e40 on {card}: cold {cold * 1e3:.3f} ms (fenced), RENDER_STATS {stats}",
          flush=True)
    print_split("bla1e40", split)
    check(stats["tier"] == "floatexp" and stats["route"] == "fe BLA kernel (registers)",
          f"bla1e40: tier {stats['tier']}, route {stats['route']}")
    check(int(stats["n_residual"]) == 0, "bla1e40: unresolved pixels")
    check(tuple(img.shape) == (sc.height, sc.width, 3), "bla1e40: shape")
    warm = []
    for _ in range(3):
        img2, dt = sync_time(lambda: render.render_u8(sc, DEVICE))
        warm.append(dt)
        check(bits_equal(img2, img), "bla1e40: a warm frame differs from the cold one")
    bla_launches = perturb_cuda.BLA_FE_LAUNCHES
    reg_launches = perturb_cuda.BLA_FE_REGISTER_LAUNCHES
    print(f"bla1e40 on {card}: warm {', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
          f"{statistics.median(warm) * 1e3:.3f} ms, equal to cold; perturb_bla_fe launches "
          f"{bla_launches} in the 4 renders, {reg_launches} in the register form (counters "
          f"zeroed before the cold one)", flush=True)
    check(bla_launches == reg_launches == 4,
          "bla1e40: the fe BLA kernel did not run once a render in the register form")
    bla_img = img

    sc = Scene(**FE1E44, precision="p32")
    zero_counters(escape_cuda, perturb_cuda)
    img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
    warm = [sync_time(lambda: render.render_u8(sc, DEVICE))[1] for _ in range(3)]
    stats = dict(perturb.RENDER_STATS)
    launches = counters(escape_cuda, perturb_cuda)
    print(f"fe1e44 p32 on {card}: cold {cold * 1e3:.3f} ms, warm "
          f"{', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
          f"{statistics.median(warm) * 1e3:.3f} ms; RENDER_STATS {stats}; launch counters "
          f"{launches}", flush=True)
    check(stats["tier"] == "p32" and stats["route"] == "kernel D",
          f"fe1e44 p32: tier {stats['tier']}, route {stats['route']}")
    check(launches["perturb_fe_full"] == 4, "fe1e44 p32: kernel D did not run each frame")
    check(len(img.reshape(-1, 3).unique(dim=0)) > 16, "fe1e44 p32: the image is nearly flat")
    return bla_launches, bla_img


def bla_case(perturb, perturb_cuda, sc, pk, n_steps: int, P, bla, glitch: bool, stats=None):
    """The fe BLA kernel's launch on the main path's arguments for the view
    ``sc`` against the packed orbit ``pk`` (every 256-row gate group of the
    view) and its plain version's: (the kernel's call, the plain version's
    call)."""
    bla = perturb._bla_tensor(bla, DEVICE)
    band = min(sc.height, perturb.PERT_BAND_ROWS)
    kw = dict(iterations=sc.iterations, height=band, width=sc.width, glitch=glitch,
              groups=-(-sc.height // band))
    return (lambda: perturb_cuda.perturb_bla_fe(pk, P, n_steps, bla, **kw),
            lambda: perturb_cuda.perturb_bla_fe_plain(pk, P, n_steps, bla, stats=stats,
                                                      **kw))


def bla_crossing_inputs(pk, bla, n_steps: int, kind: str, seed: int = 15):
    """``pk`` and the BLA table changed from ``seed`` so that the loop leaves
    kernel D's closed domain (tests/test_torch_bla_fe_domain.py runs the same
    cases on the CPU): "rows" sets Z_n's real part to 1e-40 (2 Z_n
    subnormal) on every 7th orbit row from a seeded offset; "skip" gives
    every table row A = 0 and B seeded subnormal mantissas of either sign,
    so every skip leaves dz with a subnormal mantissa."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pk = pk.clone()
    packed = np.array(bla.packed, dtype=np.float32)
    if kind == "rows":
        pk[int(rng.integers(0, 7)):n_steps:7, 0] = 1e-40
    else:
        rows = packed.shape[0]
        packed[:, 0:2] = 0.0
        packed[:, 3:5] = (rng.uniform(1e-41, 1e-39, (rows, 2))
                          * rng.choice([-1.0, 1.0], (rows, 2))).astype(np.float32)
    return pk, bla._replace(packed=packed)


def bla_cases(Scene, perturb):
    """(label, scene, packed orbit, n_steps, P, table) of the fe BLA kernel's
    checks: bla1e40 (every pixel interior), a 300-row crop of its view (212
    padded rows), the minibrot's edge (every pixel escapes after the skips)
    and fe1e44 against the corner reference (0, 0), whose table has no valid
    level (plain steps that escape, glitch and outlive the orbit: the
    streaming form, and its first 256-row group alone in the register form);
    a 2048x512 crop of bla1e40's view (1,048,576 pixels: the streaming form);
    the 300-row crop with subnormal 2 Z_n rows and with tables whose skips
    leave the closed domain (``bla_crossing_inputs``)."""
    out = []
    for label, view in (("bla1e40", BLA1E40), ("bla1e40 300-row crop", {**BLA1E40, "height": 300}),
                        ("the minibrot's edge @1e31", BLA_EDGE),
                        ("bla1e40 2048x512 crop", {**BLA1E40, "width": 2048, "height": 512})):
        sc = Scene(**view)
        clear_caches(perturb)
        st = perturb.perturb_setup(sc, DEVICE)
        check(st.bla is not None, f"{label}: the fe BLA table is not useful")
        out.append((label, sc, perturb._packed_tensor(st.orbit, DEVICE), st.n_steps, st.P,
                    st.bla))
    crop = out[1]
    for kind in ("rows", "skip"):
        pk, bla = bla_crossing_inputs(crop[2], crop[5], crop[3], kind)
        out.append((f"bla1e40 300-row crop, domain crossing ({kind})", crop[1], pk, crop[3],
                    crop[4], bla))
    sc = Scene(**FE1E44)
    orbit = perturb.reference_orbit(sc, (0, 0), sc.width, sc.height)
    fe = (perturb._packed_tensor(orbit, DEVICE), orbit.n_steps,
          perturb._pert_params_fe(sc, (0, 0), sc.width, sc.height, device=DEVICE),
          perturb._bla_for(sc, orbit, (0, 0), sc.width, sc.height, fe=True))
    out.append(("fe1e44 against the reference (0, 0)", sc, *fe))
    # its first gate group alone (rows 0-255 of the same view and P): its
    # 196,608 pixels fit the register form, the whole view's 393,216 do not
    out.append(("fe1e44 against the reference (0, 0), rows 0-255",
                sc.replace(height=perturb.PERT_BAND_ROWS), *fe))
    return out


def phase_bla_kernel(Scene, tiled, perturb, perturb_cuda, record, card, bla_img, ckpt_root):
    """The fe BLA kernel (csrc/perturb_bla_fe.cu) against its plain version,
    bit for bit, in both forms (glitch test on and off) on ``bla_cases``
    (two gate groups each, the second padded), in the state form the wrapper
    picks for each (both forms' counters zeroed before, each read after to
    show it ran); bla1e40 through the same orchestration on the plain
    versions (``render_exact(..., PLAIN)``) and in 96-row bands with a
    checkpoint, each equal to the kernel route's image; the kernel's time
    (CUDA events, and the profiler's) at bla1e40 in the register form and,
    forced through ``bla_fe_form``, in the streaming form, beside its plain
    version's and its bound from the work the plain version counts (the
    pixel-steps, skips and gates at kernel D's operations), and beside it
    the latency floor of its chain of dependent phases.  → the kernel
    row's fields."""
    from fractal_tpu_torch.utils.timing import event_ms

    perturb_cuda.BLA_FE_REGISTER_LAUNCHES = perturb_cuda.BLA_FE_STREAMING_LAUNCHES = 0
    for label, sc, pk, n_steps, P, bla in bla_cases(Scene, perturb):
        for glitch in (True, False):
            fk, fp = bla_case(perturb, perturb_cuda, sc, pk, n_steps, P, bla, glitch)
            k, t_k = sync_time(fk)
            form = perturb_cuda.BLA_FE_FORM
            p, t_p = sync_time(fp)
            compare(f"fe BLA kernel ({form}) {'glitch' if glitch else 'p32'} {label} "
                    f"{sc.width}x{sc.height}/{sc.iterations} (n_steps {n_steps}, "
                    f"{len(bla.offsets)} levels) on {card}: kernel {t_k * 1e3:.3f} ms, "
                    f"plain {t_p * 1e3:.3f} ms", k, p, record, "perturb_bla_fe",
                    f" cnt range [{int(k[2].min())}, {int(k[2].max())}], flagged "
                    f"{int(k[3].sum())}")
    forms = {"registers": perturb_cuda.BLA_FE_REGISTER_LAUNCHES,
             "streaming": perturb_cuda.BLA_FE_STREAMING_LAUNCHES}
    print(f"fe BLA kernel launches by state form in those checks: {forms}", flush=True)
    check(all(forms.values()), f"a state form of the fe BLA kernel never ran: {forms}")

    sc = Scene(**BLA1E40)
    clear_caches(perturb)
    p_img, t_plain = sync_time(lambda: perturb.render_exact(sc, DEVICE, perturb.PLAIN))
    pstats = dict(perturb.RENDER_STATS)
    eq = bits_equal(p_img, bla_img)
    print(f"bla1e40 plain route on {card}: {t_plain * 1e3:.3f} ms, RENDER_STATS {pstats}; "
          f"image == kernel route's: {eq}", flush=True)
    check(pstats["route"] == "fe BLA", f"bla1e40: the plain route took {pstats['route']}")
    check(eq, "bla1e40: the plain route's image differs from the kernel route's")
    check(int(pstats["n_residual"]) == 0, "bla1e40 plain route: unresolved pixels")

    clear_caches(perturb)
    perturb_cuda.BLA_FE_LAUNCHES = 0
    lines = []
    banded, t_band = sync_time(lambda: tiled.render_tiled(
        sc, 96, os.path.join(ckpt_root, "bla1e40"), lines.append, device=DEVICE))
    eq = bool((banded == bla_img.cpu().numpy()).all())
    print(f"bla1e40 in 96-row bands (checkpoint) on {card}: {t_band * 1e3:.3f} ms, "
          f"{len(lines)} bands, perturb_bla_fe launches {perturb_cuda.BLA_FE_LAUNCHES}; "
          f"== one-shot: {eq}", flush=True)
    check(perturb_cuda.BLA_FE_LAUNCHES == len(lines) == 4,
          "bla1e40 banded: not one fe BLA launch a band")
    check(eq, "bla1e40 banded differs from one-shot")

    clear_caches(perturb)
    st = perturb.perturb_setup(sc, DEVICE)
    work = {}
    fk, fp = bla_case(perturb, perturb_cuda, sc, perturb._packed_tensor(st.orbit, DEVICE),
                      st.n_steps, st.P, st.bla, True, stats=work)
    ms, k = event_ms(fk)
    form = perturb_cuda.BLA_FE_FORM
    check(form == "registers", f"bla1e40: the fe BLA kernel ran in the {form} form")
    p, t_plain = sync_time(fp)
    compare(f"fe BLA kernel ({form}) glitch bla1e40 on {card}: {ms:.3f} ms by events, plain "
            f"{t_plain * 1e3:.3f} ms", k, p, record, "perturb_bla_fe")
    dev = device_ms(fk, "perturb_bla_fe_kernel")
    ms, ms_by = ms_and_source(dev, ms)
    mhz = sm_clock_mhz(lambda: [fk() for _ in range(10)])
    # the same call in the streaming form, forced through the form's choice
    choose = perturb_cuda.bla_fe_form
    perturb_cuda.bla_fe_form = lambda *args: "streaming"
    try:
        s_ev, ks = event_ms(fk)
        check(perturb_cuda.BLA_FE_FORM == "streaming", "the streaming form was not forced")
        compare(f"fe BLA kernel (streaming, forced) glitch bla1e40 on {card}: {s_ev:.3f} ms by "
                f"events", ks, p, record, "perturb_bla_fe")
        s_ms, s_by = ms_and_source(device_ms(fk, "perturb_bla_fe_kernel"), s_ev)
    finally:
        perturb_cuda.bla_fe_form = choose
    # a phase is one skip attempt of every group; the group with the most
    # attempts sets the phases (with the initial one and the exit)
    g = max(range(len(work["attempts"])), key=lambda j: work["attempts"][j])
    attempts, macro = work["attempts"][g], work["macro_steps"][g]
    phases = 2 + attempts
    ops = (work["pixel_steps"] * OPS_D + work["pixel_skips"] * OPS_BLA_SKIP
           + work["gates"] * OPS_BLA_GATE)
    nbytes = (st.orbit.packed.shape[0] * 20 + st.bla.packed.nbytes + 64
              + k[0].numel() * 16)
    bound = bound_ms(ops, nbytes)
    crit = attempts * CRIT_BLA_PHASE + macro * perturb_cuda.FE_BLA_CHUNK * CRIT_D
    chain = crit * CYCLES_PER_DEPENDENT / (mhz * 1e3)
    print(f"fe BLA kernel bla1e40 on {card}: registers {ms!r} ms by the {ms_by}, streaming "
          f"(forced) {s_ms!r} ms by the {s_by}, plain {t_plain * 1e3:.3f} ms; work: gate "
          f"groups {len(work['macro_steps'])}, macro steps {work['macro_steps']}, skips "
          f"{work['skips']}, pixel-skips {work['pixel_skips']}, pixel-steps "
          f"{work['pixel_steps']}, gate pixels {work['gates']}; ops bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({ops:.4g} ops, {nbytes} bytes); attempts "
          f"{work['attempts']}; latency floor: a chain of "
          f"{phases} dependent phases, {crit} instructions x {CYCLES_PER_DEPENDENT} cycles / "
          f"{mhz:.0f} MHz (SM clock under the kernel) = {chain:.4f} ms (barriers not "
          f"counted); {ms / phases * 1e3:.3f} us a phase measured (streaming "
          f"{s_ms / phases * 1e3:.3f})", flush=True)
    return dict(ms=ms, ms_by=ms_by, plain_ms=t_plain * 1e3, bound=bound,
                extra=dict(latency_floor_ms=chain, form=form, phases=phases,
                           us_per_phase=ms / phases * 1e3, streaming_ms=s_ms))


def phase_bla_kernel_in(root, Scene, tiled, perturb, perturb_cuda, record, card, bla_img):
    """``phase_bla_kernel`` with its checkpoint under build/ (git ignores
    it), removed after."""
    ckpt_root = os.path.join(root, "build", "chip_smoke_bla_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        return phase_bla_kernel(Scene, tiled, perturb, perturb_cuda, record, card, bla_img,
                                ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def phase_fe_timing(Scene, perturb, perturb_cuda, first_ref, record, card, mhz):
    """Kernel D at the shapes the main path gives it, against its plain
    version: the grid form's glitch form over fe1e44, the points form over
    its flagged list against the first multiref reference."""
    import torch

    from fractal_tpu_torch.utils.timing import event_ms

    rec = {}
    sc = Scene(**FE1E44)
    clear_caches(perturb)
    st = perturb.perturb_setup(sc, DEVICE)
    kw = dict(iterations=sc.iterations, height=st.height, width=st.width)
    ms, k = event_ms(lambda: perturb_cuda.perturb_fe_full(st.table, st.gtol, st.P,
                                                          st.n_steps, **kw))
    p, t_plain = sync_time(lambda: perturb_cuda.perturb_fe_full_plain(
        st.table, st.gtol, st.P, st.n_steps, **kw))
    compare(f"kernel D glitch fe1e44 {st.width}x{st.height}/{sc.iterations} on {card}: {ms:.3f} ms, plain "
            f"{t_plain * 1e3:.3f} ms", k, p, record, "perturb_fe_full")
    steps = b_steps(*k, 0, st.n_steps, float(sc.limit))
    nbytes = st.table.numel() * 4 + st.gtol.numel() * 4 + 64 + st.height * st.width * 16
    rec["perturb_fe_full"] = (ms, t_plain * 1e3, *bound_ms(steps * OPS_D, nbytes))
    print(f"kernel D glitch fe1e44: {steps} pixel-steps in {ms:.3f} ms = "
          f"{steps / ms / 1e6:.2f} G steps/s", flush=True)

    idx = torch.nonzero(k[3].reshape(-1)).squeeze(1)
    table, gtol, P, n_steps = first_ref
    xs = (idx % st.width).float()
    ys = (idx // st.width).float()
    ckw = dict(iterations=sc.iterations)
    ms, k = event_ms(lambda: perturb_cuda.perturb_fe_points(table, gtol, P, n_steps, xs, ys,
                                                            **ckw))
    p, t_plain = sync_time(lambda: perturb_cuda.perturb_fe_points_plain(
        table, gtol, P, n_steps, xs, ys, **ckw))
    compare(f"kernel D points fe1e44 flagged list ({idx.numel()} px) against its first "
            f"multiref reference on {card}: {ms:.3f} ms, plain {t_plain * 1e3:.3f} ms",
            k, p, record, "perturb_fe_points")
    from fractal_tpu_torch.utils.divergence import pixel_steps

    per_px = pixel_steps(*k, 0, n_steps, float(sc.limit))
    nbytes = table.numel() * 4 + gtol.numel() * 4 + 64 + idx.numel() * (8 + 16)
    rec["perturb_fe_points"] = (ms, t_plain * 1e3, *bound_ms(int(per_px.sum()) * OPS_D, nbytes))
    rec["perturb_fe_points_floor"] = latency_floor("kernel D points", int(per_px.max()), CRIT_D,
                                                   mhz, rec["perturb_fe_points"][2:])
    return rec


# ---------------------------------------------------------------------------
# Phases 15-17: the fern and kernel H
# ---------------------------------------------------------------------------


def phase_kernel_h(fern_hist, hist_cuda, record):
    """Kernel H against its plain version on the card, bit for bit."""
    import torch

    idx, n_bins = fern_hist.fern_100m_stream(5, DEVICE)
    mixed = idx.clone().reshape(-1)
    mixed[::7] = n_bins
    mixed[3::11] = -1
    mixed[5::13] = n_bins + 9
    mixed[1::17] = -2147483648
    one_bin = torch.full_like(mixed, n_bins // 3)
    idx10, bins10 = fern_hist.fern_stream(5, DEVICE, **FERN_10M)
    idx_ss2, bins_ss2 = fern_hist.fern_stream(2, DEVICE, **FERN_100M, supersample=2)
    cases = (("a real 5-step stream", idx, n_bins), ("sentinels and negatives", mixed, n_bins),
             ("every point in one bin", one_bin, n_bins),
             ("fern_10m, a real 5-step stream", idx10, bins10),
             ("fern_100m supersample=2, a real 2-step stream", idx_ss2, bins_ss2))
    for label, stream, bins in cases:
        start = torch.randint(0, 3, (bins,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(bins)).to(DEVICE)
        k = hist_cuda.hist_accumulate(stream, start.clone())
        p = hist_cuda.hist_accumulate_plain(stream, start.clone())
        compare(f"kernel H {label}: {stream.numel()} points into {bins} bins", [k], [p],
                record, "hist", f" hits {int((k - start).sum())}, fullest bin {int(k.max())}")
        if label == "every point in one bin":
            check(int(k[n_bins // 3] - start[n_bins // 3]) == one_bin.numel(),
                  "kernel H lost hits under contention")


def phase_fern(scene_defaults, render, fern, hist_cuda, threefry, card):
    """fern_100m and fern_10m through ``render_u8(scene, "cuda")``: cold with
    a fenced split, 3 warm calls, fern_10m once with 4 replicas, then the
    same renders on the plain histogram.  Returns kernel H's launches."""
    import torch

    from fractal_tpu_torch.utils.timing import Fenced

    # the generator and a small fern on the card against the CPU
    keys = threefry.key_chain(7, 0, 4)
    u_card = threefry.uniform(keys, 70001, DEVICE)
    check(bits_equal(u_card.cpu(), threefry.uniform(keys, 70001, "cpu")),
          "the card's threefry uniforms differ from the CPU's")
    small = scene_defaults("fern").replace(width=200, height=200, iterations=1_000_000,
                                           pos=(-0.6, 0.0), seed=3)
    eq = bits_equal(render.render_u8(small, DEVICE).cpu(), render.render_u8(small, "cpu"))
    print(f"threefry uniforms on the card == on the CPU: True; 200x200 / 1,000,000 fern "
          f"on the card == on the CPU: {eq}", flush=True)
    check(eq, "the card's 200x200 fern differs from the CPU's")

    scenes = {"fern_100m": scene_defaults("fern").replace(**FERN_100M),
              "fern_10m": scene_defaults("fern").replace(**FERN_10M)}
    scenes["fern_10m x4 replicas"] = scenes["fern_10m"].replace(fern_replicas=4)
    scenes["fern_10m supersample=2"] = scenes["fern_10m"].replace(supersample=2)
    images = {}
    threefry.key_chain.cache_clear()
    hist_cuda.LAUNCHES = 0
    for name, sc in scenes.items():
        fern.SPLIT = Fenced()
        img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
        split, fern.SPLIT = fern.SPLIT, None
        stats = dict(fern.RENDER_STATS)
        print(f"{name} on {card}: cold {cold * 1e3:.3f} ms (fenced), RENDER_STATS {stats}",
              flush=True)
        print_split(name, split, details=False)
        check(stats["tier"] == "fern" and stats["route"] == "kernel H",
              f"{name}: tier {stats['tier']}, route {stats['route']}")
        check(tuple(img.shape) == (sc.height, sc.width, 3) and img.dtype == torch.uint8,
              f"{name}: image {tuple(img.shape)} {img.dtype}")
        bg = 255 if sc.fern_replicas > 1 else 240
        check(img[0, 0].tolist() == [bg] * 3 and img[-1, -1].tolist() == [bg] * 3,
              f"{name}: the corners are not the background")
        dark = float((img != bg).any(-1).float().mean())
        check(0.05 < dark < 0.9, f"{name}: the fern covers {dark} of the image")
        images[name] = img
        if sc.fern_replicas > 1 or sc.supersample > 1:
            continue
        warm = []
        for _ in range(3):
            img2, dt = sync_time(lambda: render.render_u8(sc, DEVICE))
            warm.append(dt)
            check(bits_equal(img2, img), f"{name}: a warm frame differs from the cold one")
        pts = stats["points"]
        p50 = statistics.median(warm)
        print(f"{name} on {card}: warm {', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
              f"{p50 * 1e3:.3f} ms = {p50 * 1e9 / pts:.4f} ns/point over {pts} points, "
              f"fern covers {dark:.4f} of the image", flush=True)
    launches = hist_cuda.LAUNCHES
    print(f"kernel H launches after the fern renders: {launches}", flush=True)
    check(launches > 0, "kernel H never launched on the fern path")
    for name, sc in scenes.items():
        p_img, t_plain = sync_time(lambda: fern.render_fern(
            sc, DEVICE, histogram=hist_cuda.hist_accumulate_plain))
        eq = bits_equal(p_img, images[name])
        print(f"{name} with the plain histogram on {card}: {t_plain * 1e3:.3f} ms, route "
              f"{fern.RENDER_STATS['route']}; image == kernel H's: {eq}", flush=True)
        check(fern.RENDER_STATS["route"] == "plain", f"{name}: the plain route ran kernel H")
        check(eq, f"{name}: the image on the plain histogram differs from kernel H's")
    check(hist_cuda.LAUNCHES == launches, "the plain histogram launched kernel H")
    return launches


def phase_h_timing(fern, fern_hist, hist_cuda, record, card):
    """Kernel H at the launch the main path gives it (one batch of steps of
    fern_100m) beside PyTorch's own calls on the same resident batch
    (``fern_hist.measure``), then against its plain version.  The bound
    counts the batch's indices read once and, for each bin the batch touches,
    one read and one write.  Returns (ms, plain ms, bound ms, bound by,
    library ms)."""
    import torch

    from fractal_tpu_torch.utils.timing import event_ms

    idx, n_bins = fern_hist.fern_100m_stream(fern.STEP_BATCH, DEVICE)
    n = idx.numel()
    out = fern_hist.measure(idx, n_bins)
    check(out["kernel_h_launches"] == 1, "the main path's batch took more than one launch")
    check(out["kernel_h_parity"] and out["bincount_parity"] and out["index_add_parity"],
          "torch.bincount or index_add_ disagrees with kernel H")
    zeros = torch.zeros(n_bins, dtype=torch.int32, device=DEVICE)
    k = hist_cuda.hist_accumulate(idx, zeros.clone())
    plain_ms, p = event_ms(lambda: hist_cuda.hist_accumulate_plain(idx, zeros.clone()))
    ms = out["kernel_h_ms"]
    compare(f"kernel H at its main-path launch ({n} points into {n_bins} bins) on {card}: "
            f"{ms:.4f} ms = {ms * 1e6 / n:.4f} ns/point, plain {plain_ms:.3f} ms", [k], [p],
            record, "hist")
    bound = bound_ms(n, n * 4 + out["bins_touched"] * 8)
    print(f"same batch on {card}: torch.bincount {out['bincount_ms']:.4f} ms, index_add_ "
          f"{out['index_add_ms']:.4f} ms (both equal to kernel H); the batch touches "
          f"{out['bins_touched']} of {n_bins} bins; bound {bound[0]:.4f} ms by {bound[1]}",
          flush=True)
    # where the time goes: the batch, distinct bins, the batch sorted; at
    # fern_10m's bins and at supersample=2 too
    fern_hist.diagnose(idx, n_bins)
    fern_hist.diagnose(*fern_hist.fern_stream(fern.STEP_BATCH, DEVICE, **FERN_10M))
    fern_hist.diagnose(*fern_hist.fern_stream(fern.STEP_BATCH, DEVICE, **FERN_100M,
                                              supersample=2))
    return ms, plain_ms, *bound, out["bincount_ms"]


# ---------------------------------------------------------------------------
# Phases 18-20: the probe entry point, kernels G, F and E
# ---------------------------------------------------------------------------


def phase_probes(lean_probe, probe_cuda, perturb_cuda, record, card):
    """The probe entry point's two runs with the counters of G, F and E
    zeroed before and read after and its own gates held, then each kernel's
    output of those runs against its plain version.  Returns ({name:
    launches}, {name: (ms, plain ms, bound...)})."""
    probe_cuda.CHAIN_LAUNCHES = probe_cuda.PROBE_LAUNCHES = 0
    perturb_cuda.PACKED_LAUNCHES = 0
    out, chain_res = lean_probe.run_chain(DEVICE)
    probe_out, res = lean_probe.run_probes(device=DEVICE)
    out.update(probe_out)
    launches = {"chain": probe_cuda.CHAIN_LAUNCHES, "probe": probe_cuda.PROBE_LAUNCHES,
                "perturb_packed": perturb_cuda.PACKED_LAUNCHES}
    print(f"launch counters after the probe entry point: {launches}", flush=True)
    failed = lean_probe.failures(out)
    check(not failed, f"the probe entry point's gates failed: {failed}")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the probe entry point never launched")
    rec = {}

    # 18. kernel G's modes against their plain versions
    x, a, b = lean_probe.chain_inputs(DEVICE)
    steps = lean_probe.CHAIN_STEPS
    for mode in probe_cuda.CHAIN_MODES:
        ms = out[f"chain_{mode}_ms"]
        p, t_plain = sync_time(lambda: probe_cuda.chain_plain(x, a, b, steps, mode))
        if mode == "fused":
            eq = bits_equal(chain_res[mode], p)
            print(f"kernel G fused on {card}: {ms:.3f} ms; equal to the float64-formed plain "
                  f"version: {eq} (max_abs_err {max_abs_err(chain_res[mode], p)!r}, not held)",
                  flush=True)
            continue
        compare(f"kernel G {mode} {tuple(x.shape)} x {steps} steps on {card}: {ms:.3f} ms = "
                f"{out[f'chain_{mode}_gsteps']:.1f} G elem-steps/s, plain "
                f"{t_plain * 1e3:.3f} ms", [chain_res[mode]], [p], record, "chain")
        if mode == "fma":
            rec["chain"] = (ms, t_plain * 1e3,
                            *bound_ms(x.numel() * steps * OPS_G, x.numel() * 16))

    # 19. kernel F's variants at the headline against their plain versions
    sc, st = res["scene"], res["state"]
    kw = dict(height=st.height, width=st.width)
    n0 = out["n0"]
    for variant in probe_cuda.VARIANTS:
        k, ms = res[variant], out[f"{variant}_ms"]
        p, t_plain = sync_time(lambda: probe_cuda.probe_plain(st.table, st.P, st.n_steps,
                                                              variant=variant, **kw))
        if variant == "base":
            esc = (k[3] > float(sc.limit) ** 2).long()
            steps_f = int((k[2].long() + esc - n0).clamp(min=0).sum())
            nbytes = st.table.numel() * 4 + 64 + st.height * st.width * 16
            rec["probe"] = (ms, t_plain * 1e3, *bound_ms(steps_f * OPS_B_DIST, nbytes))
        if variant == "nofreeze":  # only its count is defined
            k, p = [k[1]], [p[1]]
        compare(f"kernel F {variant} {st.height}x{st.width}/{sc.iterations} (P[8]={n0}) on "
                f"{card}: {ms:.3f} ms, plain {t_plain * 1e3:.3f} ms", k, p, record, "probe",
                f" cnt mismatches vs kernel B {out[f'{variant}_cnt_mismatch']}")

    # 20. kernel E at the headline's shape against its plain version
    k, ms = res["perturb_packed"], out["packed_ms"]
    p, t_plain = sync_time(lambda: perturb_cuda.perturb_packed_plain(
        res["packed"], st.P, st.n_steps, iterations=sc.iterations, **kw))
    compare(f"kernel E {st.height}x{st.width}/{sc.iterations} on {card}: {ms:.3f} ms, plain "
            f"{t_plain * 1e3:.3f} ms", k, p, record, "perturb_packed",
            f" flagged {int(k[3].sum())}; zr, zi, cnt, gl equal to kernel B's glitch form "
            f"({out['kernel_b_glitch_ms']:.3f} ms): {out['packed_equals_glitch_form']}")
    steps_e = b_steps(*k, n0, st.n_steps, float(sc.limit))
    nbytes = res["packed"].numel() * 4 + 64 + st.height * st.width * 16
    rec["perturb_packed"] = (ms, t_plain * 1e3, *bound_ms(steps_e * OPS_E, nbytes))
    return launches, rec


# ---------------------------------------------------------------------------
# Phases 21-23: sweeps, banded renders with checkpoints, kernel A's f32 form
# ---------------------------------------------------------------------------


def a_steps(cnt, iterations: int) -> int:
    """Loop steps kernel A ran without periodicity: a pixel's count, plus
    its escape step where it escaped."""
    cnt = cnt.long()
    return int((cnt + (cnt < iterations).long()).sum())


def jsweep_scenes(Scene, animate):
    """``bench.py:405-431``'s 256 julia frames at 1080p."""
    import numpy as np

    cs = animate.julia_c_path(np.linspace(0, 1, JSWEEP_FRAMES, endpoint=False))
    return [Scene(**JSWEEP, julia_set=(float(a), float(b))) for a, b in cs]


def phase_sweeps(Scene, animate, render, perturb, escape_cuda, perturb_cuda, card):
    """21. ``jsweep256`` as ``bench.py`` runs it (a cold call, then a warm p50
    of 3 with the exposure nudged a repeat), frames 0, 100 and 255 against
    their stills, 16 frames under the profiler (wall, device busy and idle
    share a frame); a mid-depth ds32
    sweep; zoom sweeps at dz1e12's centre (fast, 16 frames; exact at three
    zooms) and at fe1e44's needle (exact), each frame of an exact sweep
    against its still.  Counters zeroed before each sweep and read after.
    Returns the f32 launches of one jsweep256 sweep."""
    import numpy as np
    import torch

    scenes = jsweep_scenes(Scene, animate)
    zero_counters(escape_cuda, perturb_cuda)
    torch_sync()
    t0 = time.perf_counter()
    out = animate.render_sweep(scenes, device_resident=True, device=DEVICE)
    int(out[:1].sum())
    cold = time.perf_counter() - t0
    launches = counters(escape_cuda, perturb_cuda)
    f32_launches = escape_cuda.F32_LAUNCHES
    print(f"jsweep256 cold on {card}: {cold * 1e3:.3f} ms; launch counters {launches}, "
          f"kernel A f32 {f32_launches}", flush=True)
    n = JSWEEP_FRAMES
    check(f32_launches == n and launches["escape_time"] == n and launches["escape_color"] == n,
          "jsweep256 did not launch kernel A's colored f32 form once a frame")
    check(tuple(out.shape) == (n, JSWEEP["height"], JSWEEP["width"], 3)
          and out.dtype == torch.uint8, f"jsweep256: frames {tuple(out.shape)} {out.dtype}")
    for i in (0, n * 100 // 256, n - 1):
        check(bits_equal(out[i], render.render_u8(scenes[i], DEVICE)),
              f"jsweep256 frame {i} differs from its still")
    check(len(torch.unique(out[n // 2].reshape(-1, 3), dim=0)) > 16, "jsweep256: flat frame")
    print(f"jsweep256 frames 0, {n * 100 // 256}, {n - 1} == render_u8 of their scenes",
          flush=True)
    del out
    times = []
    for i in range(3):
        nudged = [s.replace(exposure=5.0 + 1e-9 * (i + 1)) for s in scenes]
        torch_sync()
        t0 = time.perf_counter()
        out = animate.render_sweep(nudged, device_resident=True, device=DEVICE)
        int(out.sum(dtype=torch.int64))
        times.append(time.perf_counter() - t0)
        del out
    p50 = statistics.median(times)
    print(f"jsweep256 on {card}: {p50!r} s p50 ({', '.join(repr(t) for t in times)}), "
          f"{n / p50!r} fps, cold {cold * 1e3!r} ms", flush=True)
    # where a frame's time goes: torch.profiler over a warm 16-frame sweep
    from fractal_tpu_torch.utils.timing import profile_warm

    wall, busy, top = profile_warm(lambda: animate.render_sweep(
        scenes[:16], device_resident=True, device=DEVICE), top=100)
    if busy is None:
        print(f"jsweep256, 16 frames under the profiler: {wall:.3f} ms wall; device time "
              f"not measured (the profiler saw no kernels)", flush=True)
    else:
        # the output's allocation and the blocks' upload are the sweep's, not a frame's
        print(f"jsweep256, 16 frames under the profiler on {card}: {wall / 16:.4f} ms wall a "
              f"frame, device busy {busy / 16:.4f} ms a frame, idle share "
              f"{1 - busy / wall:.4f}; {sum(c for _, _, c in top)} device launches and copies "
              f"in 16 frames: " + "; ".join(
                  f"{name[:60]} {ms:.3f} ms x{calls}" for name, ms, calls in top[:6]),
              flush=True)

    # the mid-depth ds32 sweep (tests/test_animate.py:46-52's view at 1080p)
    mid = [Scene(**{**MID_SWEEP, "scale": (float(s), float(s))})
           for s in np.linspace(4e5, 5e5, 8)]
    check(render.resolve_precision(mid[-1], DEVICE) == "ds32", "the mid sweep is not ds32")
    zero_counters(escape_cuda, perturb_cuda)
    out, t = sync_time(lambda: animate.render_sweep(mid, device_resident=True, device=DEVICE))
    check(escape_cuda.LAUNCHES == 8 and escape_cuda.F32_LAUNCHES == 0,
          "the ds32 sweep did not launch kernel A's ds32 form once a frame")
    for i, sc in enumerate(mid):
        check(bits_equal(out[i], render.render_u8(sc, DEVICE)), f"ds32 sweep frame {i}")
    print(f"ds32 sweep 8 x {mid[0].width}x{mid[0].height} @4e5-5e5 / {mid[0].iterations} on "
          f"{card}: {t * 1e3:.3f} ms; every frame == its still", flush=True)
    del out

    # zoom sweeps at dz1e12's centre, 1080p, 4000 iterations
    zoom = Scene(**ZOOM_SWEEP)
    clear_caches(perturb)
    zero_counters(escape_cuda, perturb_cuda)
    scales = np.geomspace(1e2, 1e12, 16)
    out, t = sync_time(lambda: animate.render_zoom_sweep(zoom, scales, device_resident=True,
                                                         device=DEVICE))
    launches = counters(escape_cuda, perturb_cuda)
    print(f"fast zoom sweep 16 x {zoom.width}x{zoom.height} / {zoom.iterations}, 1e2-1e12 on "
          f"{card}: {t!r} s; flagged a "
          f"frame {animate.SWEEP_STATS['flagged']}; launch counters {launches}", flush=True)
    check(launches["perturb_full"] == 16, "the fast zoom sweep did not launch kernel B a frame")
    distinct = len({out[i].cpu().numpy().tobytes() for i in range(16)})
    print(f"fast zoom sweep: {distinct} distinct frames of 16", flush=True)
    check(distinct >= 8, "the fast zoom sweep's frames are not distinct")
    del out
    exact_sweeps = (("dz1e12 centre", zoom, [1e6, 1e11, 1e12], "perturb_full"),
                    ("fe1e44 needle", Scene(**FE1E44), [1e38, 1e44], "perturb_fe_full"))
    for label, sc, scales, kernel in exact_sweeps:
        clear_caches(perturb)
        zero_counters(escape_cuda, perturb_cuda)
        out, t = sync_time(lambda: animate.render_zoom_sweep(
            sc, scales, device_resident=True, exact=True, device=DEVICE))
        stats = dict(animate.SWEEP_STATS)
        launches = counters(escape_cuda, perturb_cuda)
        print(f"exact zoom sweep {label} {sc.width}x{sc.height} / {sc.iterations} at {scales} "
              f"on {card}: {t!r} s; {stats}; launch counters {launches}", flush=True)
        check(launches[kernel] >= len(scales), f"{label}: {kernel} did not launch a frame")
        check(stats["n_residual"] == [0] * len(scales), f"{label}: unresolved pixels")
        # A still reuses the cached orbits whose c lies in its view (the
        # sweep's, and the secondary orbits of stills rendered before it), so
        # the stills are rendered from the sweep's cache history: its orbit
        # walked, then the flagged frames in its order, then the others.
        clear_caches(perturb)
        w, h = sc.width * sc.supersample, sc.height * sc.supersample
        perturb.reference_orbit(sc.replace(scale=(max(scales),) * 2), (w // 2, h // 2), w, h)
        order = sorted(range(len(scales)), key=lambda i: stats["flagged"][i] == 0)
        for i in order:
            s = scales[i]
            still = perturb.render_perturb(sc.replace(scale=(s, s)), DEVICE, fast=False)
            check(int(perturb.RENDER_STATS["n_residual"]) == 0, f"{label}: still residual")
            check(bits_equal(out[i], still), f"{label}: the frame at {s:g} differs from its still")
        print(f"exact zoom sweep {label}: every frame == its still (rendered in the sweep's "
              f"order from its cache state)", flush=True)
        del out
    return f32_launches


def drop_bands(ckpt: str, bands) -> None:
    """Delete ``bands``' files and take them out of the manifest."""
    path = os.path.join(ckpt, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    for b in bands:
        os.remove(os.path.join(ckpt, f"band_{b}.npy"))
    m["done"] = [b for b in m["done"] if b not in bands]
    with open(path, "w") as f:
        json.dump(m, f)


def phase_bands(Scene, tiled, render, perturb, escape_cuda, perturb_cuda, card, ckpt_root):
    """22. Banded renders against their one-shot renders: ``mp100`` with a
    checkpoint (then two bands removed and resumed, and a changed scene
    refused), ``m4k_ss2`` with an odd band size, p1e15 and fe1e44 in p32
    (bit-equal) and in the exact tier (no unresolved pixel in any band,
    every pixel no band flagged equal).  Counters zeroed before each banded
    render and read after."""
    import numpy as np
    import torch

    mp100 = Scene(**MP100)
    check(render.resolve_precision(mp100, DEVICE) == "f32", "mp100 is not f32")
    one_dev, t_cold = sync_time(lambda: render.render_u8(mp100, DEVICE))
    del one_dev
    one_dev, t_one = sync_time(lambda: render.render_u8(mp100, DEVICE))
    one, t_fetch = sync_time(lambda: one_dev.cpu().numpy())
    del one_dev
    ckpt = os.path.join(ckpt_root, "mp100")
    zero_counters(escape_cuda, perturb_cuda)
    lines = []
    banded, t_band = sync_time(lambda: tiled.render_tiled(mp100, MP100_BAND, ckpt,
                                                          lines.append, device=DEVICE))
    f32 = escape_cuda.F32_LAUNCHES
    n_bands = -(-mp100.height // MP100_BAND)
    print(f"mp100 {mp100.width}x{mp100.height} / {mp100.iterations} on {card}: one-shot "
          f"{t_one * 1e3:.3f} ms (cold {t_cold * 1e3:.3f}) + {t_fetch * 1e3:.3f} ms to the "
          f"host; banded ({MP100_BAND} rows, checkpoint) {t_band * 1e3:.3f} ms, {len(lines)} "
          f"bands, kernel A f32 launches {f32}", flush=True)
    check(f32 == n_bands and len(lines) == n_bands,
          "mp100 banded did not launch kernel A once a band")
    check(np.array_equal(banded, one), "mp100 banded differs from one-shot")
    drop_bands(ckpt, [3, 11])
    zero_counters(escape_cuda, perturb_cuda)
    lines.clear()
    resumed, t_resume = sync_time(lambda: tiled.render_tiled(mp100, MP100_BAND, ckpt,
                                                             lines.append, device=DEVICE))
    print(f"mp100 resume after removing bands 3 and 11: {t_resume * 1e3:.3f} ms, rendered "
          f"{lines}, kernel A f32 launches {escape_cuda.F32_LAUNCHES}", flush=True)
    check(escape_cuda.F32_LAUNCHES == 2 and lines == [f"band {b}/{n_bands} ({MP100_BAND} rows)"
                                                      for b in (4, 12)],
          "the resume did not render exactly the two removed bands")
    check(np.array_equal(resumed, one), "mp100 resumed differs from one-shot")
    try:
        tiled.render_tiled(mp100.replace(iterations=501), MP100_BAND, ckpt, device=DEVICE)
        check(False, "a changed scene was not refused by the checkpoint")
    except ValueError as e:
        print(f"mp100 with 501 iterations on the checkpoint: refused ({e})", flush=True)
    del banded, resumed, one

    m4k = Scene(**M4K_SS2)
    check(render.resolve_precision(m4k, DEVICE) == "ds32", "m4k_ss2 is not ds32")
    one, t_one = sync_time(lambda: render.render_u8(m4k, DEVICE))
    zero_counters(escape_cuda, perturb_cuda)
    banded, t_band = sync_time(lambda: tiled.render_tiled(m4k, 333, device=DEVICE))
    print(f"m4k_ss2 on {card}: one-shot {t_one * 1e3:.3f} ms, banded (333 -> 332 rows) "
          f"{t_band * 1e3:.3f} ms, kernel A launches {escape_cuda.LAUNCHES}", flush=True)
    check(escape_cuda.LAUNCHES == -(-m4k.height * m4k.supersample // 332),
          "m4k_ss2: a band missed kernel A")
    check(np.array_equal(banded, one.cpu().numpy()), "m4k_ss2 banded differs from one-shot")
    del one, banded

    for name, base, band_rows, kernel in (("p1e15", P1E15, 256, "perturb_dist"),
                                          ("fe1e44", FE1E44, 128, "perturb_fe_full")):
        sc = Scene(**base, precision="p32")
        clear_caches(perturb)
        one = render.render_u8(sc, DEVICE).cpu().numpy()
        zero_counters(escape_cuda, perturb_cuda)
        banded, t = sync_time(lambda: tiled.render_tiled(sc, band_rows,
                                                         os.path.join(ckpt_root, name),
                                                         device=DEVICE))
        launches = counters(escape_cuda, perturb_cuda)
        print(f"{name} p32 banded ({band_rows} rows, checkpoint) on {card}: {t * 1e3:.3f} ms; "
              f"launch counters {launches}", flush=True)
        check(launches[kernel] == -(-sc.height // band_rows), f"{name} p32: a band missed "
              f"{kernel}")
        check(np.array_equal(banded, one), f"{name} p32 banded differs from one-shot")

        sc = Scene(**base)
        clear_caches(perturb)
        one = render.render_u8(sc, DEVICE).cpu().numpy()
        st = perturb.perturb_setup(sc, DEVICE)
        flagged = (perturb._main_grid(sc, st, perturb.KERNELS, glitch=True)[3] != 0).cpu().numpy()
        zero_counters(escape_cuda, perturb_cuda)
        stats = []
        banded, t = sync_time(lambda: tiled.render_tiled(
            sc, band_rows, os.path.join(ckpt_root, name + "_exact"),
            lambda line: stats.append(dict(perturb.RENDER_STATS)), device=DEVICE))
        launches = counters(escape_cuda, perturb_cuda)
        differ = int((banded != one).any(-1).sum())
        print(f"{name} exact banded ({band_rows} rows, checkpoint) on {card}: {t * 1e3:.3f} ms; "
              f"flagged a band {[s['n_glitch'] for s in stats]} (one-shot "
              f"{int(flagged.sum())}), unresolved {[s['n_residual'] for s in stats]}; pixels "
              f"that differ from one-shot {differ}, all flagged; launch counters {launches}",
              flush=True)
        check(all(s["n_residual"] == 0 for s in stats), f"{name}: a band left pixels unresolved")
        check(sum(s["n_glitch"] for s in stats) == int(flagged.sum()),
              f"{name}: the bands flagged other pixels than the one-shot render")
        check(np.array_equal(banded[~flagged], one[~flagged]),
              f"{name} exact banded differs from one-shot on an unflagged pixel")


def phase_a_cases(Scene, escape_cuda, record):
    """23a. Kernel A's two grid forms against their plain versions, bit for
    bit, at 256x192: every rule (``A_VIEWS``) in f32 and ds32, periodicity
    on and off, 300 iterations over the whole image and 301 over a band of
    128 rows from global row 37; the colored form with inside and smooth on
    and off against ``color_plain`` of the same plain run
    (``iterate_color_plain``'s two steps)."""
    import itertools

    import torch

    n_cases = 0
    for rule, views in A_VIEWS.items():
        for prec, view in zip(escape_cuda.PRECISIONS, views):
            key = "escape_time_f32" if prec == "f32" else "escape_time"
            cnts = []
            for per, its in itertools.product((False, True), (300, 301)):
                sc = Scene(**{"width": 256, "height": 192, **view}, iterations=its)
                params = escape_cuda.scene_params(sc, device=DEVICE)
                rows = sc.height
                if its % 2:
                    params[15] = 37.0
                    rows = 128
                kw = dict(algo=sc.algo, power=sc.power, iterations=its, precision=prec,
                          height=rows, width=sc.width, periodicity=per)
                p = escape_cuda.iterate_whole(params, **kw)
                k = escape_cuda.iterate_params(params, **kw)
                what = f"{rule} {prec} periodicity {per} {its} iterations"
                compare_quiet(k, p, record, key, f"kernel A three-output {what}")
                cnts.append(p[2])
                for inside, smooth in itertools.product((True, False), (True, False)):
                    color = escape_cuda.color_params(
                        sc.replace(inside=inside, smooth=smooth), device=DEVICE)
                    img = escape_cuda.iterate_color(params, color, inside=inside,
                                                    smooth=smooth, **kw)
                    want = escape_cuda.color_plain(*p, color, inside=inside, smooth=smooth)
                    compare_quiet([img], [want], record, key,
                                  f"kernel A colored {what} inside {inside} smooth {smooth}")
                    n_cases += 1
            cnt = torch.cat([c.reshape(-1) for c in cnts])
            print(f"kernel A {rule} {prec} 256x192: three-output and colored forms bit-equal "
                  f"to their plain versions on 4 + 16 cases; counts in [{int(cnt.min())}, "
                  f"{int(cnt.max())}]", flush=True)
    print(f"kernel A colored form: {n_cases} cases bit-equal", flush=True)


def compare_quiet(k, p, record: dict, key: str, what: str) -> None:
    """``compare`` without the line: fold the error in, fail on a difference."""
    err = max(max_abs_err(a, b) for a, b in zip(k, p))
    record[key] = max(record[key], err)
    check(all(bits_equal(a, b) for a, b in zip(k, p)),
          f"the kernel differs from its plain version: {what} (max_abs_err {err!r})")


def phase_math_probe(escape_cuda, card) -> None:
    """23c. The epilogue's libdevice log2f and sqrtf (as the kernel calls
    them, under the build's flags) against torch.log2 and torch.sqrt on the
    card, on every float32 bit pattern."""
    import torch

    for op, ref in (("log2", torch.log2), ("sqrt", torch.sqrt)):
        differ = differ_num = 0
        for lo in range(0, 1 << 32, 1 << 28):
            x = (torch.arange(lo, lo + (1 << 28), dtype=torch.int64, device=DEVICE)
                 - (1 << 31)).to(torch.int32).view(torch.float32)
            y, want = escape_cuda.math_probe(op, x), ref(x)
            ne = y.view(torch.int32) != want.view(torch.int32)
            differ += int(ne.sum())
            differ_num += int((ne & ~(torch.isnan(y) & torch.isnan(want))).sum())
            del x, y, want, ne
        print(f"libdevice {op}f in csrc/escape.cu against torch.{op} on {card}: {differ} of "
              f"2^32 float32 inputs differ in their bits, {differ_num} other than in a NaN's "
              f"payload", flush=True)
        check(differ_num == 0, f"the kernel's {op}f differs from torch.{op}")


def phase_a_f32_timing(Scene, animate, render, escape_cuda, _cuda_build, record, card):
    """23b. Kernel A's f32 forms alone at a jsweep256 frame and at mp100: the
    three-output form (against ``iterate_whole`` at the frame) and the
    colored form (against ``iterate_color_plain`` at the frame, against the
    three-output form and torch's coloring at mp100), each timed by CUDA
    events and on the device by the profiler, with its pixel-steps, warp
    efficiency and bound; the f32 loop's instructions a step.  Returns the
    colored form's (ms, ms_by, plain ms, bound ms, bound by) at the frame;
    ms is the profiler's device time (where a launch is shorter than the
    host's calls around it, CUDA events read the host's time), the events'
    time, with ms_by "events", where the profiler recorded no launch."""
    from fractal_tpu_torch.tools.escape_bench import sass_loops
    from fractal_tpu_torch.utils.timing import event_ms

    out = None
    frame = jsweep_scenes(Scene, animate)[JSWEEP_FRAMES * 100 // 256]
    for name, sc in (("jsweep256 frame 100", frame), ("mp100", Scene(**MP100))):
        params = escape_cuda.scene_params(sc, device=DEVICE)
        color = escape_cuda.color_params(sc, device=DEVICE)
        kw = dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, precision="f32",
                  height=sc.height, width=sc.width, periodicity=not sc.inside)
        ckw = dict(kw, inside=sc.inside, smooth=sc.smooth)
        px = sc.width * sc.height
        ms3, k = event_ms(lambda: escape_cuda.iterate_params(params, **kw))
        dev3 = device_ms(lambda: escape_cuda.iterate_params(params, **kw), "escape_kernel", reps=5)
        steps = a_steps(k[2], sc.iterations)
        bound3 = bound_ms(steps * OPS_A_F32, 64 + px * 12)
        msc, img = event_ms(lambda: escape_cuda.iterate_color(params, color, **ckw))
        devc = device_ms(lambda: escape_cuda.iterate_color(params, color, **ckw), "escape_kernel", reps=5)
        boundc = bound_ms(steps * OPS_A_F32 + epilogue_ops(k[0], k[1], sc),
                          64 + 4 * escape_cuda.COLOR_FIELDS + px * 3)
        for form, ms, dev, bound in (("three-output", ms3, dev3, bound3),
                                     ("colored", msc, devc, boundc)):
            on_dev = ("the profiler recorded no launch" if dev is None else
                      f"{dev!r} ms on the device by the profiler = {steps / dev / 1e6:.2f} G "
                      f"steps/s, {bound[0] / dev:.3f} of the bound")
            print(f"kernel A f32 {form} {name} {sc.width}x{sc.height} / {sc.iterations} on "
                  f"{card}: {ms:.4f} ms by events ({bound[0] / ms:.3f} of the bound), "
                  f"{on_dev}; {steps} pixel-steps; bound {bound[0]:.4f} ms by {bound[1]}",
                  flush=True)
        cnt = k[2].long()
        print_efficiency(f"kernel A f32 {name}", cnt + (cnt < sc.iterations).long())
        if name.startswith("jsweep"):
            p, t_plain = sync_time(lambda: escape_cuda.iterate_whole(params, **kw))
            compare(f"kernel A f32 three-output {name}, plain {t_plain * 1e3:.3f} ms", k, p,
                    record, "escape_time_f32")
            del p
            want, t_plain = sync_time(lambda: escape_cuda.iterate_color_plain(params, color,
                                                                             **ckw))
            compare(f"kernel A f32 colored {name}, plain {t_plain * 1e3:.3f} ms", [img],
                    [want], record, "escape_time_f32")
            out = (*ms_and_source(devc, msc), t_plain * 1e3, *boundc)
        else:
            want, t_col = sync_time(lambda: render._color_and_downsample(sc, *k))
            compare(f"kernel A f32 colored {name} against the three-output form and torch's "
                    f"coloring ({t_col * 1e3:.3f} ms)", [img], [want], record, "escape_time_f32")
        del k, img, want
    per_pass = escape_cuda.F32_STEPS_PER_PASS
    sass = sass_loops(_cuda_build.BUILD_INFO["path"])
    check(len(sass) > 0, "cuobjdump -sass shows no f32 grid kernel of kernel A")
    for kname, loops in sorted(sass.items()):
        check(len(loops) > 0, f"cuobjdump found no loop in {kname}")
        print(f"sass {kname}: loops of {loops} instructions; the loop of {max(loops)} "
              f"instructions = {max(loops) / per_pass!r} a step ({per_pass} steps a pass)",
              flush=True)
    return out


def phase_rows(Scene, render, escape_cuda, perturb_cuda, card) -> None:
    """24. ``bench.py``'s julia_1080p, mb3_2k and bship_2k through
    ``render_u8``: cold, a warm p50 of 3, kernel A's colored f32 form once a
    render (counters zeroed before, read after), and the image bit-equal to
    the plain route's (``iterate_color_plain``) on the card."""
    import torch

    for name, cfg in ROWS.items():
        sc = Scene(**cfg)
        check(render.resolve_precision(sc, DEVICE) == "f32", f"{name} is not f32")
        zero_counters(escape_cuda, perturb_cuda)
        img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
        warm = [sync_time(lambda: render.render_u8(sc, DEVICE))[1] for _ in range(3)]
        launches = counters(escape_cuda, perturb_cuda)
        check(launches["escape_color"] == 4 and launches["escape_time_f32"] == 4
              and launches["escape_time"] == 4,
              f"{name} did not launch kernel A's colored f32 form once a render: {launches}")
        params = escape_cuda.scene_params(sc, device=DEVICE)
        color = escape_cuda.color_params(sc, device=DEVICE)
        want, t_plain = sync_time(lambda: escape_cuda.iterate_color_plain(
            params, color, algo=sc.algo, power=sc.power, iterations=sc.iterations,
            precision="f32", height=sc.height, width=sc.width, periodicity=not sc.inside,
            inside=sc.inside, smooth=sc.smooth))
        eq = bits_equal(img, want)
        print(f"{name} {sc.width}x{sc.height} / {sc.iterations} on {card}: cold "
              f"{cold * 1e3:.3f} ms, warm {', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
              f"{statistics.median(warm) * 1e3:.3f} ms; launch counters {launches}; plain route "
              f"{t_plain * 1e3:.3f} ms, image == plain route's: {eq}", flush=True)
        check(eq, f"{name}: the image differs from the plain route's")
        check(tuple(img.shape) == (sc.height, sc.width, 3) and img.dtype == torch.uint8
              and len(torch.unique(img.reshape(-1, 3), dim=0)) > 16, f"{name}: a flat image")


# ---------------------------------------------------------------------------
# Phase 25: f64 words on the card, kernel A's dd64 form and the f64 kernel
# ---------------------------------------------------------------------------


def mpmath_count(cr: Fraction, ci: Fraction, iterations: int, limit: float) -> int:
    """The escape count of c = cr + i ci at 50 digits (z starts at c; step i
    escapes with count i when |z|^2 > limit^2)."""
    import mpmath as mp

    with mp.workdps(50):
        c_r = mp.mpf(cr.numerator) / cr.denominator
        c_i = mp.mpf(ci.numerator) / ci.denominator
        zr, zi = c_r, c_i
        lim_sq = mp.mpf(limit) ** 2
        for i in range(iterations):
            zr, zi = zr * zr - zi * zi + c_r, 2 * zr * zi + c_i
            if zr * zr + zi * zi > lim_sq:
                return i
        return iterations


def f64_bound_ms(ops: float, nbytes: float, mhz: float):
    """The least time the card could take for f64 work: (ms, "operations" or
    "bytes"), at 64 f64 lanes an SM and the SM clock ``mhz``."""
    t_ops, t_bytes = ops / (F64_LANES * mhz * 1e6) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def image_diff(a, b) -> str:
    """How two u8 images differ: the share of pixels that differ, the
    largest channel difference, and the shares that are black in the first
    only and in the second only."""
    black_a, black_b = (a == 0).all(-1), (b == 0).all(-1)
    return (f"{float((a != b).any(-1).float().mean())!r} of pixels differ, by at most "
            f"{int((a.int() - b.int()).abs().max())} in a channel; black in the first only "
            f"{float((black_a & ~black_b).float().mean())!r}, in the second only "
            f"{float((black_b & ~black_a).float().mean())!r}")


def timed_render(render, sc, label: str, card: str):
    """``render_u8(sc)`` cold, then 3 warm calls, printed; the image."""
    import torch

    img, cold = sync_time(lambda: render.render_u8(sc, DEVICE))
    warm = [sync_time(lambda: render.render_u8(sc, DEVICE))[1] for _ in range(3)]
    print(f"{label} on {card}: cold {cold * 1e3:.3f} ms, warm "
          f"{', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
          f"{statistics.median(warm) * 1e3:.3f} ms", flush=True)
    check(tuple(img.shape) == (sc.height, sc.width, 3)
          and len(torch.unique(img.reshape(-1, 3), dim=0)) > 16, f"{label}: a flat image")
    return img


def f64_counters(escape, escape_cuda) -> dict:
    return {"escape_time_dd64": escape_cuda.DD64_LAUNCHES,
            "escape_time_f64": escape.F64_LAUNCHES, "escape_time": escape_cuda.LAUNCHES}


def zero_f64_counters(escape, escape_cuda) -> None:
    escape_cuda.DD64_LAUNCHES = escape.F64_LAUNCHES = escape_cuda.LAUNCHES = 0


def dz1e12_dd64(Scene, escape_cuda):
    """dz1e12 at dd64: the scene, its f64 block on the card and kernel A's
    keywords but ``periodicity``."""
    import torch

    dz = Scene(**DZ1E12, precision="dd64")
    params = escape_cuda.scene_params(dz, device=DEVICE, dtype=torch.float64)
    return dz, params, dict(algo=dz.algo, power=dz.power, iterations=dz.iterations,
                            precision="dd64", height=dz.height, width=dz.width)


def f64_grid(sc, viewport):
    """``sc``'s f64 pixel grid on the card and the f64 kernel's keywords."""
    import torch

    cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale, dtype=torch.float64,
                                 device=DEVICE)
    return cr, ci, dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, limit=sc.limit)


def f64_device_times() -> dict:
    """The profiler's device time of phase 25's launches at their main-path
    shapes: kernel A dd64 at dz1e12 with periodicity (``render_u8``'s
    launch) and without it, and the f64 kernel at the headline.  {label: ms,
    or None where the profiler recorded no launch}."""
    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.ops import escape, escape_cuda, viewport

    _, params, akw = dz1e12_dd64(Scene, escape_cuda)
    cr, ci, fkw = f64_grid(Scene(**HEADLINE, precision="f64"), viewport)
    return {"dd64 on": device_ms(lambda: escape_cuda.iterate_params(params, **akw,
                                                                   periodicity=True),
                                "escape_dd64_kernel"),
            "dd64 off": device_ms(lambda: escape_cuda.iterate_params(params, **akw,
                                                                     periodicity=False),
                                  "escape_dd64_kernel"),
            "f64": device_ms(lambda: escape.iterate_grid(cr, ci, **fkw), "escape_f64_kernel")}


def phase_f64_device_times(root: str) -> dict:
    """25, the profiler's readings: ``f64_device_times`` in a process of its
    own.  In this long process the profiler stops recording any kernel
    after a few sessions, whatever the device memory (seen with 64 and with
    84 GB of 85 free), and a fresh process reads each launch."""
    out = subprocess.run([sys.executable, "-c", "import json, chip_smoke; "
                          "print(json.dumps(chip_smoke.f64_device_times()))"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"phase 25's profiler process failed: {out.stderr[-3000:]}")
    dev = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"phase 25's launches on the device by the profiler, in a process of their own: "
          f"{dev}", flush=True)
    return dev


def phase_f64_cases(Scene, escape, escape_cuda, viewport, record) -> dict:
    """25a. ``escape_time_dd64`` against kernel A's plain dd64 version and
    ``escape_time_f64`` against ``iterate_grid_plain``, bit for bit, at
    256x192: every rule (``A_VIEWS``' deeper view), periodicity on and off
    for dd64, 300 iterations over the whole image and 301 over a band of 128
    rows from global row 37; the f64 kernel also on a cubic julia.  Returns
    each kernel's (ms by events, plain ms, pixel-steps, pixels) at the
    mandelbrot view's 256x192 / 300 without periodicity."""
    import torch

    from fractal_tpu_torch.utils.timing import event_ms

    n_dd = n_f64 = 0
    views = {rule: v[1] for rule, v in A_VIEWS.items()}
    views["julia 3"] = dict(views["julia"], power=3, scale=(0.6, 0.6), pos=(0.0, 0.0))
    for rule, view in views.items():
        for its in (300, 301):
            sc = Scene(**{"width": 256, "height": 192, **view}, iterations=its)
            row0, rows = (37, 128) if its % 2 else (0, sc.height)
            kw = dict(algo=sc.algo, power=sc.power, iterations=its, height=rows,
                      width=sc.width)
            for per in (False, True) if rule != "julia 3" else ():
                params = escape_cuda.scene_params(sc, device=DEVICE, dtype=torch.float64)
                params[15] = float(row0)
                dkw = dict(kw, precision="dd64", periodicity=per)
                k = escape_cuda.iterate_params(params, **dkw)
                p = escape_cuda.iterate_whole(params, **dkw)
                compare_quiet(k, p, record, "escape_time_dd64",
                              f"kernel A dd64 {rule} periodicity {per} {its} iterations")
                n_dd += 1
            cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale,
                                         dtype=torch.float64, device=DEVICE, row0=row0,
                                         rows=rows)
            fkw = dict(algo=sc.algo, power=sc.power, iterations=its, limit=sc.limit,
                       julia_set=sc.julia_set if sc.algo == "julia" else None)
            k = escape.iterate_grid(cr, ci, **fkw)
            p = escape.iterate_grid_plain(cr, ci, **fkw)
            compare_quiet(k, p, record, "escape_time_f64",
                          f"f64 kernel {rule} {its} iterations")
            check(len(torch.unique(p[2])) > 8, f"f64 {rule}: the view has no structure")
            n_f64 += 1
    print(f"kernel A dd64: {n_dd} cases bit-equal to its plain version (5 rules x "
          f"periodicity x whole/band); f64 kernel: {n_f64} cases bit-equal to "
          f"iterate_grid_plain (6 rules x whole/band); max_abs_err "
          f"{record['escape_time_dd64']!r} / {record['escape_time_f64']!r}", flush=True)
    sc = Scene(width=256, height=192, iterations=300, **views["mandelbrot"])
    params = escape_cuda.scene_params(sc, device=DEVICE, dtype=torch.float64)
    dkw = dict(algo=sc.algo, power=2, iterations=300, precision="dd64", height=sc.height,
               width=sc.width)
    cr, ci, fkw = f64_grid(sc, viewport)
    out = {}
    for name, kernel, plain in (
            ("escape_time_dd64", lambda: escape_cuda.iterate_params(params, **dkw),
             lambda: escape_cuda.iterate_whole(params, **dkw)),
            ("escape_time_f64", lambda: escape.iterate_grid(cr, ci, **fkw),
             lambda: escape.iterate_grid_plain(cr, ci, **fkw))):
        ms, k = event_ms(kernel)
        _, t_plain = sync_time(plain)
        cnt = k[2].long()
        out[name] = (ms, t_plain * 1e3, int((cnt + (cnt < 300).long()).sum()), cnt.numel())
    return out


def dd64_brent_split(escape_cuda, params, akw, on, off):
    """What Brent's test did on the main path's dd64 launch ``on`` beside
    the launch without it, ``off``: masks (escaped, ran every step, frozen,
    frozen yet escaping without the test) and a frozen pixel's steps from
    below.  A freeze step is not in the outputs: a pixel that froze within m
    steps ends the launch with periodicity at m iterations where the full
    launch leaves it, so where it does not, the pixel took more than m
    steps (m = 1, 2, 4, ...)."""
    import torch

    its = akw["iterations"]
    on_cnt, off_cnt = on[2].long(), off[2].long()
    esc = on_cnt < its
    steps = torch.zeros_like(on_cnt)
    left, prev, m = ~esc, 0, 1
    while m < its:
        zr, zi, _ = escape_cuda.iterate_params(params, **dict(akw, iterations=m),
                                               periodicity=True)
        now = left & (zr == on[0]) & (zi == on[1])
        steps[now] = prev + 1
        left &= ~now
        prev, m = m, m * 2
    ran_out = left & (off_cnt == its) & (on[0] == off[0]) & (on[1] == off[1])
    steps[left] = prev + 1
    frozen = ~esc & ~ran_out
    return esc, ran_out, frozen, frozen & (off_cnt < its), steps


def phase_f64_words(Scene, render, tiled, animate, escape, escape_cuda, viewport, dz_exact,
                    a_times, dev, card, record):
    """25b-f. dz1e12 and the headline at dd64 through ``render_u8`` (one dd64
    launch a render; the share of pixels that differ from the exact
    perturbation image and from the ds32 headline, and which way the black
    ones go), the headline at f64 through the f64 kernel (one launch a
    render, the image bit-equal to the plain route's), dz1e12 dd64 at
    1000x1000 in bands of 333 rows and a 4-frame dd64 zoom sweep (each equal
    to one-shot and its still; the kernel against its plain version there),
    and kernel A dd64 alone at dz1e12 with periodicity (the main path's
    launch) and without it, each against its plain version: what Brent's
    test froze, 16 sampled escaping pixels and 16 the main path calls
    interior against 50-digit mpmath, and each kernel's time (``dev``, the
    profiler's from ``phase_f64_device_times``; CUDA events), pixel-steps
    and bound at the f64 rate.  Returns the two kernels' JSON fields."""
    import numpy as np
    import torch

    from fractal_tpu_torch.config import exact_pos
    from fractal_tpu_torch.utils.timing import event_ms

    dz, params, akw = dz1e12_dd64(Scene, escape_cuda)
    hf = Scene(**HEADLINE, precision="f64")

    # b. dz1e12 at dd64
    zero_f64_counters(escape, escape_cuda)
    img = timed_render(render, dz, "dz1e12 dd64 (kernel A dd64, torch coloring)", card)
    dz_launches = f64_counters(escape, escape_cuda)
    print(f"launch counters after the dz1e12 dd64 renders: {dz_launches}", flush=True)
    check(dz_launches["escape_time_dd64"] == 4 and dz_launches["escape_time"] == 0,
          "dz1e12 dd64 did not launch kernel A's dd64 form once a render")
    print(f"dz1e12 dd64 against the exact perturbation image (phase 6): "
          f"{image_diff(img, dz_exact)}", flush=True)
    del img

    # c. the headline at dd64, beside the ds32 headline
    ds32 = render.render_u8(Scene(**HEADLINE), DEVICE)
    hd = Scene(**HEADLINE, precision="dd64")
    zero_f64_counters(escape, escape_cuda)
    himg = timed_render(render, hd, "headline dd64", card)
    check(f64_counters(escape, escape_cuda)["escape_time_dd64"] == 4,
          "the dd64 headline did not launch kernel A's dd64 form once a render")
    print(f"headline dd64 against the ds32 headline: {image_diff(himg, ds32)}", flush=True)
    del himg, ds32

    # d. the headline at f64 through the f64 kernel
    zero_f64_counters(escape, escape_cuda)
    fimg = timed_render(render, hf, "headline f64 (f64 kernel, torch coloring)", card)
    f64_launches = f64_counters(escape, escape_cuda)
    print(f"launch counters after the f64 headline renders: {f64_launches}", flush=True)
    check(f64_launches["escape_time_f64"] == 4 and f64_launches["escape_time"] == 0,
          "the f64 headline did not launch the f64 kernel once a render")
    small = hf.replace(width=1000, height=1000)
    cr, ci, fkw = f64_grid(small, viewport)
    p, t_small = sync_time(lambda: escape.iterate_grid_plain(cr, ci, **fkw))
    eq = bits_equal(render.render_u8(small, DEVICE),
                    render._color_and_downsample(small, *p))
    print(f"headline f64 1000x1000: plain route {t_small * 1e3:.3f} ms; image == plain "
          f"route's: {eq}", flush=True)
    check(eq, "headline f64 1000x1000: the image differs from the plain route's")
    f_shape, f_dev = small, None  # the profiler read the launch at 3000x3000
    if t_small * 9 <= 15.0:
        f_shape, f_dev = hf, dev["f64"]
        cr, ci, fkw = f64_grid(hf, viewport)
        p, t_plain = sync_time(lambda: escape.iterate_grid_plain(cr, ci, **fkw))
        eq = bits_equal(fimg, render._color_and_downsample(hf, *p))
        print(f"headline f64 3000x3000: plain route {t_plain * 1e3:.3f} ms; image == plain "
              f"route's: {eq}", flush=True)
        check(eq, "headline f64: the image differs from the plain route's")
    else:
        t_plain = t_small
        print("headline f64 3000x3000 plain route skipped: 9x its 1000x1000 time is over "
              "15 s", flush=True)
    del fimg
    f_ms, k = event_ms(lambda: escape.iterate_grid(cr, ci, **fkw))
    compare(f"f64 kernel headline {f_shape.width}x{f_shape.height}", k, p, record,
            "escape_time_f64")
    f_cnt = k[2].long()
    f_steps = int((f_cnt + (f_cnt < hf.iterations).long()).sum())
    del k, p, cr, ci

    # e. bands and a sweep at dd64
    d1 = dz.replace(width=1000, height=1000)
    zero_f64_counters(escape, escape_cuda)
    one, t_one = sync_time(lambda: render.render_u8(d1, DEVICE))
    banded, t_band = sync_time(lambda: tiled.render_tiled(d1, band_rows=333, device=DEVICE))
    eq = np.array_equal(banded, one.cpu().numpy())
    print(f"dz1e12 dd64 1000x1000 on {card}: one-shot {t_one * 1e3:.3f} ms, banded (333 rows, "
          f"4 bands) {t_band * 1e3:.3f} ms, equal: {eq}; launches "
          f"{f64_counters(escape, escape_cuda)}", flush=True)
    check(eq and escape_cuda.DD64_LAUNCHES == 5, "dz1e12 dd64 bands differ from one-shot")
    p1 = escape_cuda.scene_params(d1, device=DEVICE, dtype=torch.float64)
    kw1 = dict(akw, height=d1.height, width=d1.width, periodicity=True)
    pl, t_pl = sync_time(lambda: escape_cuda.iterate_whole(p1, **kw1))
    compare(f"kernel A dd64 dz1e12 1000x1000, periodicity on, plain {t_pl * 1e3:.3f} ms",
            escape_cuda.iterate_params(p1, **kw1), pl, record, "escape_time_dd64")
    del pl
    frames = [d1.replace(scale=(float(s), float(s))) for s in np.geomspace(1e9, 1e12, 4)]
    out, t_sweep = sync_time(lambda: animate.render_sweep(frames, device=DEVICE,
                                                          device_resident=True))
    same = [bits_equal(out[i], render.render_u8(f, DEVICE)) for i, f in enumerate(frames)]
    print(f"dd64 zoom sweep, 4 frames 1e9-1e12 at 1000x1000 / 4000: {t_sweep * 1e3:.3f} ms; "
          f"each frame == its still: {same}", flush=True)
    check(all(same), "a dd64 sweep frame differs from its still")
    del out, one

    # f. kernel A dd64 alone at dz1e12's 3000x3000, with periodicity (the
    # main path's launch) and without it, each against its plain version
    mhz = sm_clock_mhz(lambda: [escape_cuda.iterate_params(params, **akw, periodicity=False)
                                for _ in range(3)])
    runs = {}
    for per in (True, False):
        ms, k = event_ms(lambda: escape_cuda.iterate_params(params, **akw, periodicity=per))
        p, t = sync_time(lambda: escape_cuda.iterate_whole(params, **akw, periodicity=per))
        compare(f"kernel A dd64 dz1e12 3000x3000 periodicity {per}, plain {t * 1e3:.3f} ms",
                k, p, record, "escape_time_dd64")
        runs[per] = (ms, k, t * 1e3)
        del p
    (on_ms, on, on_plain), (off_ms, off, off_plain) = runs[True], runs[False]
    its, n_px = dz.iterations, dz.width * dz.height
    on_cnt, off_cnt = on[2].long(), off[2].long()
    esc, ran_out, frozen, wrong, frozen_steps = dd64_brent_split(escape_cuda, params, akw, on,
                                                                 off)
    check(torch.equal(on_cnt[esc], off_cnt[esc]),
          "dz1e12 dd64: a pixel that escapes with periodicity has another count without it")

    (Ar, Cr), (Ai, Ci) = viewport.affine_fractions(dz.width, dz.height, exact_pos(dz),
                                                   dz.scale)
    rng = np.random.default_rng(25)

    def mp_sample(mask, n):
        ys, xs = np.nonzero(mask.cpu().numpy())
        pts = [(int(ys[i]), int(xs[i])) for i in rng.choice(len(xs), min(n, len(xs)),
                                                             replace=False)]
        return pts, [mpmath_count(Ar * x + Cr, Ai * y + Ci, its, dz.limit) for y, x in pts]

    t0 = time.perf_counter()
    pts, want = mp_sample(esc, 16)
    got = [int(on_cnt[y, x]) for y, x in pts]
    print(f"dz1e12 dd64: 16 sampled escaping pixels, counts {got}; 50-digit mpmath "
          f"{want} ({time.perf_counter() - t0:.1f} s)", flush=True)
    check(got == want, "dz1e12 dd64: a sampled pixel's count differs from mpmath")
    t0 = time.perf_counter()
    pts_w, want_w = mp_sample(wrong, 8)
    pts_h, want_h = mp_sample(~esc & ~wrong, 16 - len(pts_w))
    got_on = [int(on_cnt[y, x]) for y, x in pts_w + pts_h]
    got_off = [int(off_cnt[y, x]) for y, x in pts_w + pts_h]
    n_held, n_wrong = int((~esc).sum()), int(wrong.sum())
    print(f"dz1e12 dd64: the main path calls {n_held} pixels interior: {int(ran_out.sum())} "
          f"ran all {its} steps, {int(frozen.sum())} were frozen by Brent's test, "
          f"{n_wrong} of them ({n_wrong / n_px!r} of the image) escape without it; 16 "
          f"sampled ({len(pts_w)} of those {n_wrong}): counts {got_on}, without periodicity "
          f"{got_off}, 50-digit mpmath {want_w + want_h} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(got_off == want_w + want_h,
          "dz1e12 dd64: a sampled interior pixel's count without periodicity differs from "
          "mpmath")

    step_on = OPS_DD64 + OPS_BRENT
    on_ops = ((int(on_cnt[esc].sum()) * step_on + int(esc.sum()) * OPS_DD64)
              + (int(ran_out.sum()) * its + int(frozen_steps[frozen].sum())) * step_on)
    off_steps = int((off_cnt + (off_cnt < its).long()).sum())
    on_bound = f64_bound_ms(on_ops, 128 + n_px * 20, mhz)
    off_bound = f64_bound_ms(off_steps * OPS_DD64, 128 + n_px * 20, mhz)
    f_bound = f64_bound_ms(f_steps * OPS_F64, f_shape.width * f_shape.height * 36, mhz)
    print(f"SM clock under the dd64 loop: {mhz:.0f} MHz -> f64 peak "
          f"{F64_LANES * mhz * 1e6:.4e} ops/s", flush=True)
    for name, ops in (("escape_time_dd64", OPS_DD64), ("escape_time_f64", OPS_F64)):
        ms, plain_ms, steps, px = a_times[name]
        bound = f64_bound_ms(steps * ops, px * (20 if name.endswith("dd64") else 36), mhz)
        print(f"{name} 256x192 / 300 (the mandelbrot view, no periodicity) on {card}: "
              f"{ms:.4f} ms by events, {steps} pixel-steps, bound {bound[0]:.4f} ms by "
              f"{bound[1]}; plain {plain_ms:.3f} ms", flush=True)

    def timed(label, ev, d, bound, steps=None):
        rate = "" if steps is None or d is None else f" = {steps / d / 1e6:.2f} G steps/s"
        on_dev = ("not recorded by the profiler" if d is None else
                  f"{d!r} ms on the device{rate} ({bound[0] / d:.3f} of the bound)")
        return (f"{label}: {ev:.3f} ms by events ({bound[0] / ev:.3f} of the bound), "
                f"{on_dev}; bound {bound[0]:.3f} ms by {bound[1]}")

    print(f"kernel A dd64 dz1e12 3000x3000 / {its} on {card}: "
          + timed(f"periodicity on (the main path's launch; {on_ops} f64 ops, frozen pixels' "
                  f"steps counted from below)", on_ms, dev["dd64 on"], on_bound)
          + "; " + timed(f"off, {off_steps} pixel-steps", off_ms, dev["dd64 off"], off_bound,
                         off_steps)
          + f"; plain {on_plain:.3f} / {off_plain:.3f} ms", flush=True)
    print(f"f64 kernel headline {f_shape.width}x{f_shape.height} / {hf.iterations} on {card}: "
          + timed(f"{f_steps} pixel-steps", f_ms, f_dev, f_bound, f_steps)
          + f"; plain {t_plain * 1e3:.3f} ms", flush=True)
    on_t, on_by = ms_and_source(dev["dd64 on"], on_ms)
    off_t, off_by = ms_and_source(dev["dd64 off"], off_ms)
    f_t, f_by = ms_and_source(f_dev, f_ms)
    return {"escape_time_dd64": dict(
                launches=dz_launches["escape_time_dd64"], ms=on_t, ms_by=on_by,
                plain_ms=on_plain, bound=on_bound,
                extra=dict(periodicity_off_ms=off_t, periodicity_off_ms_by=off_by,
                           periodicity_off_plain_ms=off_plain,
                           periodicity_off_bound_ms=off_bound[0])),
            "escape_time_f64": dict(launches=f64_launches["escape_time_f64"], ms=f_t,
                                    ms_by=f_by, plain_ms=t_plain * 1e3, bound=f_bound)}


# ---------------------------------------------------------------------------
# Phase 26: the viewer, --trace and --backend
# ---------------------------------------------------------------------------


def grid_counters(escape, escape_cuda, perturb_cuda, hist_cuda, native_walk) -> dict:
    """Every launch counter a viewer frame or a CLI route can move, and the
    native walker's orbits and direct pixels."""
    return {**counters(escape_cuda, perturb_cuda), "hist": hist_cuda.LAUNCHES,
            "escape_time_f32_grid": escape.F32_GRID_LAUNCHES,
            "escape_time_f32_grid_color": escape.F32_GRID_COLOR_LAUNCHES,
            "escape_time_f64": escape.F64_LAUNCHES,
            "escape_time_dd64": escape_cuda.DD64_LAUNCHES,
            **{f"native {k}": v for k, v in native_walk.WALKS.items()}}


def zero_all(escape, escape_cuda, perturb_cuda, hist_cuda, native_walk) -> None:
    """Every launch counter of ``grid_counters`` to 0 (the walker's counts
    stay: they are read as changes)."""
    zero_counters(escape_cuda, perturb_cuda)
    zero_f64_counters(escape, escape_cuda)
    hist_cuda.LAUNCHES = escape.F32_GRID_LAUNCHES = escape.F32_GRID_COLOR_LAUNCHES = 0


def count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def f32_grid_main_path(Scene, viewport):
    """``--backend jnp``'s main path shape: mp100's view at 1920x1080 / 500
    in f32; the scene, its f32 pixel grid on the card and the grid
    kernel's keywords."""
    import torch

    sc = Scene(**{**MP100, **BACKEND_SHAPE}, precision="f32")
    cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale, dtype=torch.float32,
                                 device=DEVICE)
    return sc, cr, ci, grid_kw(sc)


def grid_kw(sc) -> dict:
    """The f32 grid loop's keywords for ``sc``."""
    return dict(algo=sc.algo, power=sc.power, iterations=sc.iterations, limit=sc.limit,
                julia_set=sc.julia_set if sc.algo == "julia" else None)


def grid_color_kw(sc, row0: int = 0, rows: int = None) -> dict:
    """``iterate_grid_color``'s keywords for rows [row0, row0 + rows) of
    ``sc`` (all of them by default)."""
    return dict(grid_kw(sc), width=sc.width, height=sc.height, pos=sc.pos, scale=sc.scale,
                inside=sc.inside, smooth=sc.smooth, row0=row0, rows=rows)


def device_times_26() -> dict:
    """The profiler's device time of the f32 grid loop's two forms at
    ``--backend jnp``'s main-path shape (``f32_grid_main_path``), and of
    kernel A's points form at phase 9's (the ``FALLBACK_1E8`` view's flagged
    list): {label: ms, or None where the profiler recorded no launch}."""
    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.ops import escape, escape_cuda, perturb, perturb_cuda, viewport
    from fractal_tpu_torch.tools.escape_bench import GRID_KERNELS

    sc, cr, ci, kw = f32_grid_main_path(Scene, viewport)
    color = escape_cuda.color_params(sc, device=DEVICE)
    _, params, xs, ys, akw = a_points_case(Scene(**FALLBACK_1E8), perturb, perturb_cuda,
                                           escape_cuda)
    calls = {"f32 grid": (lambda: escape.iterate_grid(cr, ci, **kw), GRID_KERNELS[0]),
             "f32 grid color": (lambda: escape.iterate_grid_color(color, **grid_color_kw(sc)),
                                GRID_KERNELS[1]),
             "escape_points": (lambda: escape_cuda.iterate_points(params, xs, ys, **akw),
                               "escape_points_kernel")}
    out = {}
    for label, (fn, name) in calls.items():
        fn()
        torch_sync()
        out[label] = device_ms(fn, name)
    return out


def phase_f32_grid_cases(Scene, escape, escape_cuda, viewport, record) -> None:
    """26a. First the colored form's c (``grid_c_probe``) against
    ``pixel_grid`` on the card at 1920x1080, bit for bit, on every rule's
    view, whole and on a band of 500 rows from global row 37.  Then both f32
    grid forms against their plain versions, bit for bit: the three-output
    ``escape_time_f32_grid`` against ``iterate_grid_plain`` and the colored
    ``escape_time_f32_grid_color`` against ``color_plain`` of the same plain
    run (``iterate_grid_color_plain``'s last two steps on the same grid),
    inside and smooth in turn, at 256x192 unless said: every rule
    (``A_VIEWS``' shallow view) and a cubic julia at 300 iterations over the
    whole image and 301 over a band of 128 rows from global row 37; each at
    budgets 0, 1, 2 and 3; 250x190 (tiles cut at both edges) whole at 301 and
    on a band of 101 rows from row 37 at 300; limit 1e20 (limit^2 is inf in
    f32: exterior pixels overflow to inf and NaN and run to the budget) at
    300 and 301; a wide view (scale 1e-5) whose corner pixels start outside
    the limit."""
    import itertools

    import torch

    views = {rule: v[0] for rule, v in A_VIEWS.items()}
    views["julia 3"] = dict(views["julia"], power=3, pos=(0.0, 0.0))
    for rule, view in views.items():
        sc = Scene(**{**view, **BACKEND_SHAPE})
        for row0, rows in ((0, None), (37, 500)):
            k = escape.grid_c_probe(sc.width, sc.height, sc.pos, sc.scale, row0, rows, DEVICE)
            p = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale, dtype=torch.float32,
                                    device=DEVICE, row0=row0, rows=rows)
            compare_quiet(k, p, record, "escape_time_f32_grid_color",
                          f"the colored form's c, {rule} 1920x1080 from row {row0}")
    print(f"f32 grid colored form: c formed in the kernel == pixel_grid on the card at "
          f"1920x1080, {len(views)} views x whole/band", flush=True)

    size = dict(width=256, height=192)
    cases = []  # (label, scene, row0, rows)
    for rule, view in views.items():
        for its in (300, 301):
            cases.append((f"{rule} {its}", Scene(**size, **view, iterations=its),
                          *((37, 128) if its % 2 else (0, None))))
    for rule, view in views.items():
        for its in (0, 1, 2, 3):
            cases.append((f"{rule} budget {its}", Scene(**size, **view, iterations=its), 0, None))
        cases.append((f"{rule} 250x190 301", Scene(**{**view, "width": 250, "height": 190},
                                                   iterations=301), 0, None))
        cases.append((f"{rule} 250x190 300 band", Scene(**{**view, "width": 250, "height": 190},
                                                        iterations=300), 37, 101))
        for its in (300, 301):
            cases.append((f"{rule} limit 1e20 {its}", Scene(**size, **view, iterations=its,
                                                            limit=1e20), 0, None))
        cases.append((f"{rule} wide", Scene(**size, **view, iterations=300).replace(
            scale=(1e-5, 1e-5)), 0, None))
    looks = itertools.cycle(itertools.product((True, False), (True, False)))
    for label, sc, row0, rows in cases:
        inside, smooth = next(looks)
        sc = sc.replace(inside=inside, smooth=smooth)
        cr, ci = viewport.pixel_grid(sc.width, sc.height, sc.pos, sc.scale,
                                     dtype=torch.float32, device=DEVICE, row0=row0, rows=rows)
        kw = grid_kw(sc)
        k = escape.iterate_grid(cr, ci, **kw)
        p = escape.iterate_grid_plain(cr, ci, **kw)
        check(k[0].dtype == torch.float32, "the f32 grid kernel returned another type")
        compare_quiet(k, p, record, "escape_time_f32_grid", f"f32 grid kernel {label}")
        color = escape_cuda.color_params(sc, device=DEVICE)
        img = escape.iterate_grid_color(color, **grid_color_kw(sc, row0, rows))
        want = escape_cuda.color_plain(*p, color, inside=inside, smooth=smooth)
        compare_quiet([img], [want], record, "escape_time_f32_grid_color",
                      f"f32 grid colored {label} inside {inside} smooth {smooth}")
        its = sc.iterations
        if "limit" in label:
            check(bool(torch.isnan(p[0]).any()) and bool((p[2] == its).all()),
                  f"f32 grid {label}: no pixel ran on as NaN to the budget")
        elif "wide" in label:
            check(bool((cr * cr + ci * ci > float(sc.limit) ** 2).any())
                  and bool((p[2] == 0).any()), f"f32 grid {label}: no pixel starts outside")
        elif its >= 300:
            check(len(torch.unique(p[2])) > 8, f"f32 grid {label}: the view has no structure")
    print(f"f32 grid kernel and its colored form: {len(cases)} cases each bit-equal to their "
          f"plain versions (budgets 0-3, 300, 301, 250x190, limit 1e20, a wide view; "
          f"{len(views)} rules); max_abs_err {record['escape_time_f32_grid']!r} and "
          f"{record['escape_time_f32_grid_color']!r}", flush=True)


def phase_backends(Scene, render, mods, viewport, dev, card, record) -> dict:
    """26b. ``render_u8(..., backend=)`` on the card.  "jnp" at f32 at mp100's
    view in 1080p: one launch of the colored form a render, the image
    bit-equal to ``iterate_grid_color_plain``'s and to the plain grid route's
    (``pixel_grid``, ``iterate_grid_plain``, torch's coloring); at
    supersample 2 (the same grid) one launch of the three-output form, the
    image bit-equal to the plain route's; cold and warm p50 of 3 each.  Each
    form at that grid against its plain version, timed by events and by the
    profiler (``dev``), with pixel-steps, bound, warp efficiency (rows of 32
    against 8x4 tiles) and SASS instructions a pass.  "pallas" at f64 equals
    the f32 colored route's (the JAX package's pallas route reads f64 as one
    f32 word).  Returns the two forms' JSON fields."""
    from fractal_tpu_torch.ops import _cuda_build
    from fractal_tpu_torch.tools.escape_bench import GRID_KERNELS, sass_loops
    from fractal_tpu_torch.utils.timing import event_ms

    escape, escape_cuda = mods[0], mods[1]
    sc, cr, ci, kw = f32_grid_main_path(Scene, viewport)
    ss2 = sc.replace(width=sc.width // 2, height=sc.height // 2, supersample=2)
    runs = {}
    for name, scene, want_launch, want_route in (
            ("supersample 1", sc, "escape_time_f32_grid_color", render.GRID_COLOR_ROUTE),
            ("supersample 2", ss2, "escape_time_f32_grid",
             "f32 grid kernel (escape_time_f32_grid)")):
        zero_all(*mods)
        before = grid_counters(*mods)
        img, cold = sync_time(lambda: render.render_u8(scene, DEVICE, "jnp"))
        warm = [sync_time(lambda: render.render_u8(scene, DEVICE, "jnp"))[1] for _ in range(3)]
        launches = count_delta(grid_counters(*mods), before)
        route = render.RENDER_STATS["route"]
        print(f"--backend jnp, mp100's view {scene.width}x{scene.height} {name} / "
              f"{scene.iterations} f32 on {card}: cold {cold * 1e3:.3f} ms, warm "
              f"{', '.join(f'{t * 1e3:.3f}' for t in warm)} ms, p50 "
              f"{statistics.median(warm) * 1e3:.3f} ms; route {route!r}; launches {launches}",
              flush=True)
        check(launches == {want_launch: 4},
              f"--backend jnp {name} did not launch {want_launch} once a render: {launches}")
        check(route == want_route, f"--backend jnp {name} took {route!r}")
        runs[name] = (img, launches.get(want_launch, 0))

    color = escape_cuda.color_params(sc, device=DEVICE)
    ckw = grid_color_kw(sc)
    want, t_plain_c = sync_time(lambda: escape.iterate_grid_color_plain(color, **ckw))
    p, t_plain = sync_time(lambda: escape.iterate_grid_plain(cr, ci, **kw))
    eq = (bits_equal(runs["supersample 1"][0], want)
          and bits_equal(want, render._color_and_downsample(sc, *p)))
    eq2 = bits_equal(runs["supersample 2"][0], render._color_and_downsample(ss2, *p))
    print(f"--backend jnp images == the plain routes' on the card: supersample 1 {eq} "
          f"(iterate_grid_color_plain {t_plain_c * 1e3:.3f} ms, == pixel_grid + "
          f"iterate_grid_plain + torch's coloring), supersample 2 {eq2}", flush=True)
    check(eq and eq2, "--backend jnp: the image differs from the plain grid route's")

    ms3, k = event_ms(lambda: escape.iterate_grid(cr, ci, **kw))
    compare(f"f32 grid kernel {sc.width}x{sc.height} / {sc.iterations}", k, p, record,
            "escape_time_f32_grid")
    msc, img = event_ms(lambda: escape.iterate_grid_color(color, **ckw))
    compare(f"f32 grid colored kernel {sc.width}x{sc.height} / {sc.iterations}", [img], [want],
            record, "escape_time_f32_grid_color")
    cnt = p[2].long()
    per_px = cnt + (cnt < sc.iterations).long()
    steps = int(per_px.sum())
    bound3 = bound_ms(steps * OPS_F32_GRID, cnt.numel() * 20)
    boundc = bound_ms(steps * OPS_F32_GRID + epilogue_ops(p[0], p[1], sc),
                      4 * escape_cuda.COLOR_FIELDS + cnt.numel() * 3)
    out = {}
    for key, label, ms, d, bound, plain, name in (
            ("escape_time_f32_grid", "escape_time_f32_grid", ms3, dev["f32 grid"], bound3,
             t_plain, "supersample 2"),
            ("escape_time_f32_grid_color", "escape_time_f32_grid_color", msc,
             dev["f32 grid color"], boundc, t_plain_c, "supersample 1")):
        on_dev = ("not recorded by the profiler" if d is None else
                  f"{d!r} ms on the device ({bound[0] / d:.3f} of the bound, "
                  f"{steps / d / 1e6:.2f} G steps/s)")
        print(f"{label} {sc.width}x{sc.height} / {sc.iterations} on {card}: {ms:.4f} ms by "
              f"events ({bound[0] / ms:.3f} of the bound), {on_dev}; {steps} pixel-steps, "
              f"bound {bound[0]:.4f} ms by {bound[1]}; plain {plain * 1e3:.3f} ms", flush=True)
        t, by = ms_and_source(d, ms)
        out[key] = dict(launches=runs[name][1], ms=t, ms_by=by, plain_ms=plain * 1e3,
                        bound=bound)
    print_efficiency(f"f32 grid mp100's view {sc.width}x{sc.height} / {sc.iterations}", per_px)
    per_pass = escape.F32_GRID_STEPS_PER_PASS
    for kernel in GRID_KERNELS:
        sass = sass_loops(_cuda_build.BUILD_INFO["path"], kernel=kernel)
        check(len(sass) > 0 and all(sass.values()), f"cuobjdump found no loop in {kernel}")
        for kname, loops in sorted(sass.items()):
            print(f"sass {kname}: loops of {loops} instructions; the loop of {max(loops)} "
                  f"instructions = {max(loops) / per_pass!r} a step ({per_pass} steps a pass)",
                  flush=True)
    del k, p, img, want

    # "pallas" at f64 renders kernel A's f32 form
    f64 = sc.replace(precision="f64")
    before = grid_counters(*mods)
    a = render.render_u8(f64, DEVICE, "pallas")
    b = render.render_u8(sc, DEVICE, "pallas")
    c = render.render_u8(sc, DEVICE)
    pal = count_delta(grid_counters(*mods), before)
    same = bits_equal(a, b) and bits_equal(b, c)
    print(f"--backend pallas --precision f64 == --backend pallas f32 == auto f32 on the card: "
          f"{same}; launches {pal}; the f64 route's image differs on "
          f"{image_diff(a, render.render_u8(f64, DEVICE))}", flush=True)
    check(same and pal.get("escape_color") == 3 and "escape_time_f64" not in pal,
          "--backend pallas --precision f64 did not render kernel A's f32 colored form")
    return out


def http_get(base: str, path: str):
    import urllib.request

    r = urllib.request.urlopen(base + path, timeout=120)
    return r.headers, r.read()


def http_post(base: str, path: str, obj) -> dict:
    import urllib.request

    req = urllib.request.Request(base + path, json.dumps(obj).encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=120).read() or b"{}")


def decode_png(png: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def cache_state(perturb) -> dict:
    """A copy of the perturbation tier's host caches (each dict copied; no
    entry is changed in place)."""
    return {name: dict(val) for name, val in vars(perturb).items()
            if name.endswith("_CACHE") and isinstance(val, dict)}


def restore_caches(perturb, state: dict) -> None:
    for name, val in state.items():
        cache = getattr(perturb, name)
        cache.clear()
        cache.update(val)


def viewer_gen(base: str) -> int:
    return int(http_get(base, "/image")[0]["X-Gen"])


def viewer_request(base, path, body, viewer, render, perturb, mods, label, card,
                   latency=None):
    """One viewer request on an idle worker: POST ``body`` to ``path``, wait
    (long-polling /image) for the one frame it makes, and hold the decoded
    PNG bit-equal to ``render(scene, "cuda")`` of GET /scene, rendered from
    the host caches the frame found.  (The exact tier's reference follows
    its caches: a view with no memo of its own takes the most central cached
    orbit inside it, so a second render of a panned view may start from an
    orbit that the first one's resolve walked; that second render is
    compared too, and reported.)  The frame's launches are the counters'
    change from the post to the frame.  Prints the headers, the encode time
    (PIL, timed here on the frame) and the wall from the post to the PNG;
    appends them to ``latency``.  Returns (headers, scene, launches)."""
    import numpy as np

    g0 = viewer_gen(base)
    caches = cache_state(perturb)
    before = grid_counters(*mods)
    t0 = time.perf_counter()
    http_post(base, path, body)
    while True:
        h, png = http_get(base, f"/image?gen={g0}")
        if int(h["X-Gen"]) > g0:
            break
        check(time.perf_counter() - t0 < 120, f"viewer {label}: no frame in 120 s (a failed "
              f"render is only printed)")
    wall = (time.perf_counter() - t0) * 1e3
    launches = count_delta(grid_counters(*mods), before)
    check(int(h["X-Gen"]) == g0 + 1, f"viewer {label}: {int(h['X-Gen']) - g0} frames for "
          f"one request")
    sc = viewer.scene_from_dict(json.loads(http_get(base, "/scene")[1]))
    img = decode_png(png)
    t1 = time.perf_counter()
    viewer._encode_png(img)
    enc = (time.perf_counter() - t1) * 1e3
    with viewer._RENDER_LOCK:
        again = render.render(sc, DEVICE)
        restore_caches(perturb, caches)
        still = render.render(sc, DEVICE)
    eq = img.shape == still.shape and bool(np.array_equal(img, still))
    gap = np.abs(again.astype(int) - img).max(-1)
    black_a, black_i = (again == 0).all(-1), (img == 0).all(-1)
    second = ("equal" if not gap.any() else
              f"{int((gap > 0).sum())} pixels differ, {int((gap > 1).sum())} by more than 1 "
              f"in a channel, {int((black_a != black_i).sum())} black in one only")
    fields = {k: h[k] for k in ("X-Gen", "X-Tier", "X-Route", "X-Glitch", "X-Residual",
                                "X-Device-Ms", "X-Render-Ms")}
    print(f"viewer {label} ({sc.width}x{sc.height}, {len(png)} B PNG) on {card}: {fields}; "
          f"encode {enc:.3f} ms (PIL, timed here); wall from request to PNG {wall:.3f} ms; "
          f"frame launches {launches}; == render(scene, 'cuda') from the frame's caches: {eq}; "
          f"a second render: {second}", flush=True)
    check(eq, f"viewer {label}: the frame differs from render(scene, 'cuda')")
    if latency is not None:
        latency.append((label, float(h["X-Device-Ms"]), float(h["X-Render-Ms"]), enc, wall))
    return h, sc, launches


def viewer_drain(base: str) -> None:
    """Until no new generation appears for a second: a render still running
    on the card at teardown can crash the interpreter."""
    g, quiet = viewer_gen(base), time.perf_counter()
    while time.perf_counter() - quiet < 1.0:
        time.sleep(0.1)
        if viewer_gen(base) != g:
            g, quiet = viewer_gen(base), time.perf_counter()


def phase_viewer(Scene, render, viewer, cli, perturb, mods, card, out_dir) -> dict:
    """26c. ``viewer.start`` on the card at 1920x1080, in this process: the
    first frame (f32, kernel A's colored form), dz1e12's centre at 1e12x /
    4000 by POST /pos (perturb on kernel B; X-Residual 0) and five arrow
    pans, fe1e44's needle at 768x512 (floatexp on kernel D), /reset to
    julia and to the fern at 1080p (kernel H), 15 rapid posts at 1080p /
    2000 (1-5 renders, the last the last post's), and the 2x screenshot
    equal to its still.  Every frame equals ``render(scene, "cuda")``.
    Returns the launches of the viewer's frames by kernel."""
    import numpy as np
    from PIL import Image

    shot = os.path.join(out_dir, "shot")
    opts = cli.parse_options(["1920", "1080", "-o", shot, "--format", "png"])
    seen: dict = {}
    latency: list = []

    def step(path, body, label, tier, keep=True):
        h, sc, launches = viewer_request(base, path, body, viewer, render, perturb, mods,
                                         label, card, latency if keep else None)
        check(h["X-Tier"] == tier, f"viewer {label}: tier {h['X-Tier']!r}, not {tier!r}")
        for k, v in launches.items():
            seen[k] = seen.get(k, 0) + v
        return h, sc, launches

    zero_all(*mods)
    before = grid_counters(*mods)
    srv = viewer.start(opts, port=0, open_browser=False, block=False, device=DEVICE)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # 1. the first frame
        t0 = time.perf_counter()
        h, png = http_get(base, "/image?gen=0")
        while int(h["X-Gen"]) < 1:
            check(time.perf_counter() - t0 < 120, "viewer: no first frame in 120 s")
            h, png = http_get(base, "/image?gen=0")
        wall = (time.perf_counter() - t0) * 1e3
        first = count_delta(grid_counters(*mods), before)
        sc = viewer.scene_from_dict(json.loads(http_get(base, "/scene")[1]))
        with viewer._RENDER_LOCK:
            still = render.render(sc, DEVICE)
        img = decode_png(png)
        eq = bool(np.array_equal(img, still))
        t1 = time.perf_counter()
        viewer._encode_png(img)
        enc = (time.perf_counter() - t1) * 1e3
        print(f"viewer first frame ({sc.width}x{sc.height}) on {card}: tier {h['X-Tier']}, "
              f"X-Device-Ms {h['X-Device-Ms']}, X-Render-Ms {h['X-Render-Ms']}, encode "
              f"{enc:.3f} ms, wall from start to PNG {wall:.3f} ms (cold: the CUDA context's "
              f"first colored launch); launches {first}; == render(scene, 'cuda'): {eq}",
              flush=True)
        check(eq and h["X-Tier"] == "f32" and first.get("escape_color") == 1,
              "viewer: the first frame is not kernel A's colored f32 image")
        latency.append(("first frame", float(h["X-Device-Ms"]), float(h["X-Render-Ms"]),
                        enc, wall))
        seen.update(first)
        step("/config", {**json.loads(http_get(base, "/scene")[1]), "exposure": 5.5},
             "f32 warm frame", "f32")

        # 2. dz1e12's centre, then five arrow pans (one 60 ms tick each)
        scene = json.loads(http_get(base, "/scene")[1])
        step("/config", {**scene, "iterations": 4000, "inside": False}, "f32 at 4000", "f32")
        h, _, _ = step("/pos", {"x": repr(SEAHORSE[0]), "y": repr(SEAHORSE[1]), "scale": 1e12},
                       "dz1e12 centre 1e12x / 4000 (cold)", "perturb")
        check(h["X-Route"] == "cuda kernels" and h["X-Residual"] == "0",
              f"viewer dz1e12: route {h['X-Route']!r}, residual {h['X-Residual']!r}")
        pans = {}
        for i in range(5):
            h, _, fl = step("/nav", {"pan": [0.03, 0.0]}, f"pan {i + 1}", "perturb")
            check(h["X-Route"] == "cuda kernels" and h["X-Residual"] == "0",
                  f"viewer pan {i + 1}: route {h['X-Route']!r}, residual {h['X-Residual']!r}")
            for k, v in fl.items():
                pans[k] = pans.get(k, 0) + v
        print(f"viewer: the 5 pans' frames (32 pixels each) launched and walked {pans}",
              flush=True)

        # 3. fe1e44's needle at 768x512
        scene = json.loads(http_get(base, "/scene")[1])
        step("/config", {**scene, "width": 768, "height": 512, "iterations": 2000},
             "dz1e12 centre 768x512 / 2000", "perturb", keep=False)
        h, _, _ = step("/pos", {"x": NEEDLE_X, "y": "0.0", "scale": 1e44},
                       "fe1e44 needle 768x512 (cold)", "floatexp")
        check(h["X-Route"] == "kernel D" and h["X-Residual"] == "0",
              f"viewer fe1e44: route {h['X-Route']!r}, residual {h['X-Residual']!r}")

        # 4. /reset to julia and to the fern, at 1080p
        step("/reset", {"algo": "julia"}, "reset julia 768x512", "f32", keep=False)
        scene = json.loads(http_get(base, "/scene")[1])
        step("/config", {**scene, "width": 1920, "height": 1080}, "julia 1080p", "f32")
        _, _, fl = step("/reset", {"algo": "fern"}, "reset fern 1080p", "fern")
        check(fl.get("hist", 0) > 0, f"viewer fern: kernel H did not launch: {fl}")

        # 5. coalescing: 15 rapid posts at 1080p / 2000
        step("/reset", {"algo": "mandelbrot"}, "reset mandelbrot 1080p", "f32", keep=False)
        scene = json.loads(http_get(base, "/scene")[1])
        h, _, _ = step("/config", {**scene, "iterations": 2000}, "1080p / 2000", "f32",
                       keep=False)
        scene = json.loads(http_get(base, "/scene")[1])
        g0 = int(h["X-Gen"])
        t0 = time.perf_counter()
        for i in range(15):
            scene["exposure"] = 2.0 + 0.25 * (i + 1)
            http_post(base, "/config", scene)
        burst = (time.perf_counter() - t0) * 1e3
        last = viewer.scene_from_dict(scene)
        with viewer._RENDER_LOCK:
            want = render.render(last, DEVICE)
        deadline = time.perf_counter() + 120
        while True:
            h, png = http_get(base, "/image")
            if int(h["X-Gen"]) > g0 and np.array_equal(decode_png(png), want):
                break
            check(time.perf_counter() < deadline, "viewer: the last post never rendered")
            time.sleep(0.02)
        n = int(h["X-Gen"]) - g0
        print(f"viewer coalescing: 15 posts in {burst:.3f} ms gave {n} renders (a frame "
              f"{h['X-Render-Ms']} ms with its encode); the last frame == the last post's "
              f"still", flush=True)
        check(1 <= n <= 5, f"viewer coalescing: {n} renders for 15 posts")
        viewer_drain(base)

        # 6. the 2x screenshot
        big = last.replace(width=last.width * 2, height=last.height * 2)
        with viewer._RENDER_LOCK:
            want = render.render(big, DEVICE)
        t0 = time.perf_counter()
        http_post(base, "/screenshot", {})
        got = None
        while got is None:
            try:
                got = np.asarray(Image.open(shot + ".png").convert("RGB"))
            except (OSError, SyntaxError):  # not written yet, or half written
                check(time.perf_counter() - t0 < 120, "viewer: no screenshot in 120 s")
                time.sleep(0.05)
        eq = got.shape == want.shape == (2160, 3840, 3) and bool(np.array_equal(got, want))
        print(f"viewer screenshot {got.shape[1]}x{got.shape[0]}: written in "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms; == render of the 2x scene: {eq}",
              flush=True)
        check(eq, "viewer: the 2x screenshot differs from its still")
        viewer_drain(base)
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"viewer latency on {card} (ms; X-Device-Ms is the render and its copy to the host, "
          f"X-Render-Ms adds the PNG encode):", flush=True)
    for label, dms, rms, enc, wall in latency:
        print(f"  {label}: X-Device-Ms {dms}, X-Render-Ms {rms}, encode {enc:.3f}, wall "
              f"request to PNG {wall:.3f}", flush=True)
    print(f"viewer frames' launches by kernel: {seen}", flush=True)
    for k in ("escape_color", "perturb_full", "perturb_fe_full", "hist"):
        check(seen.get(k, 0) > 0, f"viewer: no frame launched {k}")
    return seen


def phase_trace(root: str, out_dir: str, card: str) -> None:
    """26d. ``python -m fractal_tpu_torch 1920 1080 --trace DIR`` on the
    card: the ``*.pt.trace.json`` holds a kernel event of kernel A's
    colored form."""
    import glob

    trace = os.path.join(out_dir, "trace")
    env = {k: v for k, v in os.environ.items() if k != "FRACTAL_TPU_PLATFORM"}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "fractal_tpu_torch", "1920", "1080", "--trace",
                          trace, "--format", "png", "-o", os.path.join(out_dir, "traced")],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"--trace failed: {out.stderr[-3000:]}")
    check(f"trace written to {trace}" in out.stdout, "--trace did not say where it wrote")
    files = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    check(len(files) == 1, f"--trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    a = [e for e in kernels if "escape_kernel" in e.get("name", "")]
    print(f"--trace 1920x1080 on {card}: {time.perf_counter() - t0:.1f} s, "
          f"{os.path.getsize(files[0])} B, {len(events)} events, {len(kernels)} kernel events; "
          f"kernel A: {[(e['name'][:120], e.get('dur')) for e in a]}", flush=True)
    check(len(kernels) > 0, "--trace recorded no kernel event (CUPTI missing?)")
    check(len(a) == 1 and ("<" not in a[0]["name"] or "true>" in a[0]["name"]),
          "--trace holds no single event of kernel A's colored form")


def phase_viewer_and_flags(Scene, render, viewer, cli, escape, escape_cuda, perturb,
                           perturb_cuda, hist_cuda, native_walk, viewport, root, card,
                           record):
    """26. The f32 grid loop's cases, ``--backend`` on the card, the viewer
    and ``--trace``.  Returns the f32 grid forms' JSON fields and the
    profiler's readings (``device_times_26``)."""
    t26 = time.perf_counter()
    out_dir = os.path.join(root, "build", "chip_smoke_viewer")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        phase_f32_grid_cases(Scene, escape, escape_cuda, viewport, record)
        out = subprocess.run([sys.executable, "-c", "import json, chip_smoke; "
                              "print(json.dumps(chip_smoke.device_times_26()))"],
                             cwd=root, capture_output=True, text=True, timeout=600)
        check(out.returncode == 0, f"phase 26's profiler process failed: {out.stderr[-3000:]}")
        dev = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"phase 26's launches on the device by the profiler, in a process of their own: "
              f"{dev}", flush=True)
        mods = (escape, escape_cuda, perturb_cuda, hist_cuda, native_walk)
        grid = phase_backends(Scene, render, mods, viewport, dev, card, record)
        phase_viewer(Scene, render, viewer, cli, perturb, mods, card, out_dir)
        phase_trace(root, out_dir, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 26: {time.perf_counter() - t26:.1f} s", flush=True)
    return grid, dev


# ---------------------------------------------------------------------------
# Phase 27: the device mesh on the card
# ---------------------------------------------------------------------------

# bla1e40's pixels that the 4-shard fe BLA route renders otherwise than one
# device (the skip gate is a max over a stripe there, over a 256-row band on
# one device, as in the reference's two routes: ROADMAP §3)
BLA_MESH_DIFF = 0


def mesh_launches(escape, escape_cuda, perturb_cuda, hist_cuda) -> dict:
    return {**counters(escape_cuda, perturb_cuda), "hist": hist_cuda.LAUNCHES,
            "grid": escape.F32_GRID_LAUNCHES + escape.F32_GRID_COLOR_LAUNCHES}


def zero_mesh_launches(escape, escape_cuda, perturb_cuda, hist_cuda) -> None:
    zero_counters(escape_cuda, perturb_cuda)
    hist_cuda.LAUNCHES = escape.F32_GRID_LAUNCHES = escape.F32_GRID_COLOR_LAUNCHES = 0


def mesh_pair(label, one_fn, mesh_fn, perturb, mods, card, want: dict, reps: int = 3):
    """One device's image and the mesh's, each cold from cleared caches and
    then warm (p50 of ``reps``), bit for bit; the mesh's cold render's
    launches (zeroed just before it, read just after) against ``want``."""
    warm = {}
    clear_caches(perturb)
    one, one_cold = sync_time(one_fn)
    warm["one device"] = statistics.median(sync_time(one_fn)[1] for _ in range(reps)) * 1e3
    clear_caches(perturb)
    zero_mesh_launches(*mods)
    got, mesh_cold = sync_time(mesh_fn)
    launches = mesh_launches(*mods)
    stats = dict(perturb.RENDER_STATS)
    eq = bits_equal(got, one)
    warm["mesh"] = statistics.median(sync_time(mesh_fn)[1] for _ in range(reps)) * 1e3
    perturb.RENDER_STATS.update(stats)  # the cold render's
    seen = {k: launches[k] for k in want}
    print(f"mesh {label} on {card}: == one device: {eq}; cold {one_cold * 1e3:.3f} / "
          f"{mesh_cold * 1e3:.3f} ms, warm p50 one device {warm['one device']!r} ms, mesh "
          f"{warm['mesh']!r} ms; the mesh render's launches {seen}", flush=True)
    check(eq, f"mesh {label}: the image differs from one device's")
    check(seen == want, f"mesh {label}: launches {seen}, want {want}")
    return got, stats.get("n_residual")


def mesh_bla(Scene, render, sharding, perturb, perturb_cuda, card):
    """bla1e40 on 4 shards of this card: the fe BLA kernel once a stripe
    (one gate group each; its counter zeroed before the mesh's render, read
    after), its differing pixels against one device held at
    ``BLA_MESH_DIFF``."""
    import torch

    sc = Scene(**BLA1E40)
    clear_caches(perturb)
    one, t_one = sync_time(lambda: render.render_u8(sc, DEVICE))
    clear_caches(perturb)
    perturb_cuda.BLA_FE_LAUNCHES = 0
    mesh = sharding.Mesh((torch.device("cuda", 0),) * 4)
    got, t_mesh = sync_time(lambda: sharding.render_perturb_sharded(sc, mesh))
    launches = perturb_cuda.BLA_FE_LAUNCHES
    route = perturb.RENDER_STATS["route"]
    diff = int((got != one).any(-1).sum())
    print(f"mesh bla1e40, 4 shards on {card}: {route}, {diff} of {one.shape[0] * one.shape[1]} "
          f"pixels differ from one device (held at {BLA_MESH_DIFF}); cold {t_one * 1e3:.3f} / "
          f"{t_mesh * 1e3:.3f} ms; perturb_bla_fe launches {launches}", flush=True)
    check(route == "sharded fe BLA kernel (registers)" and diff == BLA_MESH_DIFF,
          f"mesh bla1e40: route {route}, {diff} pixels differ")
    check(launches == 4, f"mesh bla1e40: {launches} fe BLA launches, not one a stripe")


def phase_mesh(Scene, scene_defaults, render, animate, tiled, viewer, sharding, escape,
               escape_cuda, perturb, perturb_cuda, hist_cuda, root, card):
    """27. Logical meshes on one card (several shards on cuda:0), each
    render bit-equal to one device's from the same cleared caches, one
    main-grid launch a shard; the viewer, the CLI and two ranks over gloo."""
    import numpy as np
    import torch

    t27 = time.perf_counter()
    mods = (escape, escape_cuda, perturb_cuda, hist_cuda)
    cuda = torch.device("cuda", 0)

    def mesh(n):
        return sharding.Mesh((cuda,) * n)

    for n in (2, 4, 7):  # 3000 rows on 7 shards pad to 3003
        for tier, key in (("exact (auto)", "escape_color"), ("p32", "perturb_dist")):
            sc = Scene(**HEADLINE, precision="p32") if tier == "p32" else Scene(**HEADLINE)
            mesh_pair(f"headline {tier}, {n} shards", lambda: render.render_u8(sc, DEVICE),
                      lambda: sharding.render_escape_sharded(sc, mesh(n)), perturb, mods,
                      card, {key: n})
    for name, view, key in (("dz1e12", DZ1E12, "perturb_full"),
                            ("fe1e44", FE1E44, "perturb_fe_full")):
        sc = Scene(**view)
        _, nres = mesh_pair(f"{name}, 4 shards", lambda: render.render_u8(sc, DEVICE),
                            lambda: sharding.render_perturb_sharded(sc, mesh(4)), perturb,
                            mods, card, {key: 4})
        print(f"mesh {name}: n_glitch {perturb.RENDER_STATS['n_glitch']}, n_residual {nres}, "
              f"route {perturb.RENDER_STATS['route']}", flush=True)
        check(nres == 0, f"mesh {name}: {nres} unresolved pixels")
    mesh_bla(Scene, render, sharding, perturb, perturb_cuda, card)

    fsc = scene_defaults("fern").replace(**FERN_100M)
    zero_mesh_launches(*mods)
    render.render_u8(fsc, DEVICE)
    one_h = hist_cuda.LAUNCHES
    mesh_pair("fern_100m exact mode, 4 shards", lambda: render.render_u8(fsc, DEVICE),
              lambda: sharding.render_fern_sharded(fsc, mesh(4)), perturb, mods, card,
              {"hist": 4 * one_h}, reps=1)

    scenes = jsweep_scenes(Scene, animate)
    mesh_pair("jsweep256 frame-parallel, 4 shards",
              lambda: animate.render_sweep(scenes, device_resident=True, device=DEVICE),
              lambda: animate.render_sweep(scenes, device_resident=True, mesh=mesh(4)),
              perturb, mods, card, {"escape_color": JSWEEP_FRAMES}, reps=1)

    ckpt = os.path.join(root, "build", "chip_smoke_mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        mp = Scene(**MP100)
        one = render.render_u8(mp, DEVICE).cpu().numpy()
        band = MP100["height"] // 20
        zero_mesh_launches(*mods)
        banded, t_band = sync_time(lambda: tiled.render_tiled(mp, band, ckpt, mesh=mesh(4)))
        launches = mesh_launches(*mods)["escape_color"]
        drop_bands(ckpt, (3, 17))
        zero_mesh_launches(*mods)
        resumed, t_res = sync_time(lambda: tiled.render_tiled(mp, band, ckpt, mesh=mesh(4)))
        relaunch = mesh_launches(*mods)["escape_color"]
        ok = np.array_equal(banded, one) and np.array_equal(resumed, one)
        print(f"mesh mp100 in 20 bands of {band} rows, 4 shards, checkpointed, on {card}: "
              f"== one-shot: {ok}; {t_band * 1e3:.3f} ms, {launches} launches; resumed "
              f"after two bands were removed {t_res * 1e3:.3f} ms, {relaunch} launches",
              flush=True)
        check(ok and launches == 80 and relaunch == 8, "mesh mp100 bands")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    worker = viewer.RenderWorker(mesh=mesh(3), device=DEVICE)
    for sc in (Scene(**ROWS["julia_1080p"]),
               Scene(**{**DZ1E12, "width": 1920, "height": 1080}, precision="p32")):
        clear_caches(perturb)
        g0 = worker.snapshot()[0]
        worker.request(sc)
        g, png, ms, stats = worker.wait_for(g0, timeout=120)
        clear_caches(perturb)
        want = render.render(sc, DEVICE)
        eq = g > g0 and np.array_equal(decode_png(png), want)
        print(f"mesh viewer frame {sc.width}x{sc.height} {stats.get('tier')}: == render: {eq}, "
              f"X-Devices {stats.get('devices')}, {ms:.1f} ms", flush=True)
        check(eq and stats.get("devices") == 3, "a mesh viewer frame")

    from fractal_tpu_torch.__main__ import main as cli_main

    out_dir = os.path.join(root, "build", "chip_smoke_mesh_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        flags = "1920 1080 -s 3e5 -x -.7436447860 -y .1318252536 -i 2000 --format png"
        pngs = {}
        for n in ("1", "0"):
            out = os.path.join(out_dir, f"d{n}")
            check(cli_main(f"{flags} --devices {n} -o {out}".split()) == 0, "the CLI failed")
            with open(out + ".png", "rb") as f:
                pngs[n] = decode_png(f.read())
        eq = np.array_equal(pngs["0"], pngs["1"])
        try:
            cli_main(f"{flags} --devices 2 -o {out_dir}/d2".split())
            refused = ""
        except SystemExit as e:
            refused = str(e)
        print(f"CLI --devices 0 PNG == --devices 1 PNG: {eq}; --devices 2: {refused!r}",
              flush=True)
        check(eq, "the CLI's --devices 0 PNG differs from --devices 1's")
        check(refused == f"error: --devices 2: only {torch.cuda.device_count()} device(s) "
                         f"available", "--devices 2 did not exit with the reference's message")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "fractal_tpu_torch.tools.dryrun_mesh", "4",
                          "--ranks", "2"], cwd=root, capture_output=True, text=True,
                         timeout=300)
    lines = out.stdout.strip().splitlines()
    print(f"dryrun_mesh 4 --ranks 2 on {card} ({time.perf_counter() - t0:.1f} s): "
          f"{lines[-1] if lines else out.stderr[-2000:]}", flush=True)
    check(out.returncode == 0 and json.loads(lines[-1])["ok"],
          f"the two-rank dry run failed: {out.stderr[-2000:]}")
    elapsed = time.perf_counter() - t27
    print(f"phase 27: {elapsed:.1f} s", flush=True)
    check(elapsed <= 90, f"phase 27 took {elapsed:.1f} s, more than its 90 s")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 28: the CPU's f32 BLA route beside the card's
# ---------------------------------------------------------------------------


def phase_cpu_route(Scene, render, perturb, escape_cuda, perturb_cuda, card) -> None:
    """28. ``F32_BLA_VIEW`` in p32 and exact: on the host's CPU through the
    f32 BLA route, on the card through kernel B, and kernel B's route on the
    CPU; the images compared and each render's wall time printed."""
    import torch

    t0 = time.perf_counter()
    for tier in ("p32", "perturb"):
        sc = Scene(**F32_BLA_VIEW, precision=tier)
        label = f"{tier} {sc.width}x{sc.height} / {sc.iterations} at the spiral"
        clear_caches(perturb)
        cpu_img, t_cpu = sync_time(lambda: render.render_u8(sc, "cpu"))
        cpu_stats = dict(perturb.RENDER_STATS)
        check(cpu_stats["route"] == "f32 BLA" and cpu_stats["tier"] == tier,
              f"{label}: the CPU took {cpu_stats['route']!r} ({cpu_stats['tier']})")
        clear_caches(perturb)
        zero_counters(escape_cuda, perturb_cuda)
        card_img, t_card = sync_time(lambda: render.render_u8(sc, DEVICE))
        card_stats = dict(perturb.RENDER_STATS)
        launches = counters(escape_cuda, perturb_cuda)
        kernel = "perturb_dist" if tier == "p32" else "perturb_full"
        check(card_stats["route"] == "cuda kernels" and launches[kernel] == 1,
              f"{label}: the card took {card_stats['route']!r}, launches {launches}")
        warm = [sync_time(lambda: render.render_u8(sc, DEVICE))[1] for _ in range(3)]
        clear_caches(perturb)
        plain_img, t_plain = sync_time(lambda: perturb.render_perturb(
            sc, "cpu", fast=tier == "p32", grids=perturb.CARD_ROUTE))
        card_img = card_img.cpu()
        n_diff = int((cpu_img != card_img).any(-1).sum())
        print(f"{label}: the CPU's f32 BLA route {t_cpu * 1e3:.3f} ms (RENDER_STATS "
              f"{cpu_stats}); on {card} kernel B's route cold {t_card * 1e3:.3f} ms, warm p50 "
              f"{statistics.median(warm) * 1e3:.3f} ms, launches {launches}; kernel B's route "
              f"on the CPU {t_plain * 1e3:.3f} ms, == the card's image: "
              f"{bits_equal(plain_img, card_img)}; the f32 BLA image differs from the card's "
              f"on {n_diff} of {sc.width * sc.height} pixels (at most {F32_BLA_MISMATCH})",
              flush=True)
        check(bits_equal(plain_img, card_img),
              f"{label}: kernel B's route on the CPU differs from the card's")
        check(n_diff <= F32_BLA_MISMATCH, f"{label}: {n_diff} pixels differ from the card's")
        check(len(torch.unique(cpu_img.reshape(-1, 3), dim=0)) > 16, f"{label}: a flat image")
    print(f"phase 28: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "test needs a CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import importlib

        render = importlib.import_module("fractal_tpu_torch.render")
        from fractal_tpu_torch import animate, cli, tiled, viewer
        from fractal_tpu_torch.config import Scene, scene_defaults
        from fractal_tpu_torch.models import fern
        from fractal_tpu_torch.ops import (_cuda_build, escape, escape_cuda, hist_cuda,
                                           native_walk, perturb, perturb_cuda, probe_cuda,
                                           threefry, viewport)
        from fractal_tpu_torch.tools import fern_hist, lean_probe
        from fractal_tpu_torch.tools.escape_bench import sass_loops
        from fractal_tpu_torch.utils.timing import event_ms
    except ImportError as e:
        raise SmokeFailure(f"the fractal_tpu_torch package is not beside "
                           f"chip_smoke.py: {e}")
    import mpmath

    t_start = time.perf_counter()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} mpmath {mpmath.__version__}", flush=True)
    card = card_line()
    print(card, flush=True)

    # 2. builds
    t0 = time.perf_counter()
    _cuda_build.load()
    info = _cuda_build.BUILD_INFO
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc {info['seconds']:.2f} s) -> {os.path.relpath(info['path'], root)}",
          flush=True)
    resources = _cuda_build.kernel_resources(info["log"])
    if resources:
        regs = [r for _, r, _ in resources]
        print(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"{sum(sp for _, _, sp in resources)} bytes of spill stores", flush=True)
    for name, n_regs, spill in resources:  # the delta-orbit kernels' forms
        if re.search(r"perturb_(fe_full|fe_points|full|points|dist|bla_fe)_kernel"
                     r"|escape_(dd64|f64|f32_grid|f32_grid_color)_kernel", name):
            print(f"ptxas: {name}: {n_regs} registers, {spill} bytes of spill stores",
                  flush=True)
    t0 = time.perf_counter()
    check(native_walk.available(), "the native orbit walker did not build or load")
    print(f"native walker build: {time.perf_counter() - t0:.2f} s wall (g++ "
          f"{native_walk.BUILD_INFO['seconds']:.2f} s) -> "
          f"{os.path.relpath(native_walk.BUILD_INFO['path'], root)}", flush=True)

    # A small render of another view first brings up the CUDA context and
    # loads PyTorch's own kernels, so "cold" is each view's own first call.
    render.render_u8(Scene(width=64, height=64, iterations=50), DEVICE)
    torch_sync()

    # 3. the headline path
    scenes, images, head_launches = phase_headline(Scene, render, escape_cuda,
                                                   perturb_cuda, card)

    # 4. kernels against their plain versions
    record = {k: 0.0 for k in ("escape_time", "escape_time_f32", "escape_points", "perturb_dist",
                               "perturb_full", "perturb_points", "perturb_fe_full",
                               "perturb_fe_points", "hist", "chain", "probe",
                               "perturb_packed", "escape_time_dd64", "escape_time_f64",
                               "escape_time_f32_grid", "escape_time_f32_grid_color",
                               "perturb_bla_fe")}
    phase_kernel_a(Scene, escape_cuda, record)
    phase_kernel_b(Scene, perturb, perturb_cuda, record)
    phase_bad_reference_and_points(Scene, perturb, perturb_cuda, escape_cuda, record)
    phase_kernel_c(Scene, perturb, perturb_cuda, _cuda_build, record)
    phase_long_budget(Scene, perturb, perturb_cuda, _cuda_build, record, card)

    # 5. the headline kernels at their 3000x3000 shape
    exact = scenes["exact (auto)"]
    params = escape_cuda.scene_params(exact, device=DEVICE)
    akw = dict(algo="mandelbrot", power=2, iterations=exact.iterations,
               precision="ds32", height=exact.height, width=exact.width, periodicity=True)
    a3_ms, a_out = event_ms(lambda: escape_cuda.iterate_params(params, **akw))
    a_ref, a_plain = sync_time(lambda: escape_cuda.iterate_whole(params, **akw))
    compare("kernel A ds32 3000x3000/4000, periodicity on", a_out, a_ref, record,
            "escape_time")
    # the colored form, which the exact tier's render launches
    color = escape_cuda.color_params(exact, device=DEVICE)
    ckw = dict(akw, inside=exact.inside, smooth=exact.smooth)
    a_ms, a_img = event_ms(lambda: escape_cuda.iterate_color(params, color, **ckw))
    want, t_col = sync_time(lambda: escape_cuda.color_plain(*a_ref, color, inside=exact.inside,
                                                            smooth=exact.smooth))
    a_plain += t_col
    a_color_ops = epilogue_ops(a_ref[0], a_ref[1], exact)
    a_dev = device_ms(lambda: escape_cuda.iterate_color(params, color, **ckw), "escape_kernel")
    print(f"kernel A ds32 3000x3000/4000 on {card}: three-output {a3_ms:.3f} ms, colored "
          f"{a_ms:.3f} ms by events, {a_dev!r} ms on the device by the profiler; plain "
          f"{a_plain * 1e3:.3f} ms", flush=True)
    compare("kernel A ds32 colored 3000x3000/4000, periodicity on", [a_img], [want], record,
            "escape_time")
    del a_out, a_ref, a_img, want
    # the exact cell's own frame: the colored form at a stills_around centre
    still = Scene(**{k: v for k, v in HEADLINE.items() if k != "pos"}, pos_str=STILLS_CENTRE)
    s_params = escape_cuda.scene_params(still, device=DEVICE)
    s_ms, s_img = event_ms(lambda: escape_cuda.iterate_color(s_params, color, **ckw))
    s_dev = device_ms(lambda: escape_cuda.iterate_color(s_params, color, **ckw),
                      "escape_kernel")
    want, t_plain = sync_time(lambda: escape_cuda.iterate_color_plain(s_params, color, **ckw))
    print(f"kernel A ds32 colored at the stills_around centre {STILLS_CENTRE} on {card}: "
          f"{s_ms:.3f} ms by events, {s_dev!r} ms on the device by the profiler; plain "
          f"{t_plain * 1e3:.3f} ms", flush=True)
    compare("kernel A ds32 colored 3000x3000/4000 at a stills_around centre, periodicity on",
            [s_img], [want], record, "escape_time")
    del s_img, want
    # the ds32 loop's machine instructions: one step a pass
    sass = sass_loops(_cuda_build.BUILD_INFO["path"], word="ZD")
    check(len(sass) > 0 and all(sass.values()), "cuobjdump found no ds32 loop of kernel A")
    for kname, loops in sorted(sass.items()):
        print(f"sass {kname}: loops of {loops} instructions; the loop of {max(loops)} "
              f"instructions a step (OPS_A_DS32 {OPS_A_DS32})", flush=True)
    st = perturb.perturb_setup(scenes["p32"], DEVICE)
    bkw = dict(height=st.height, width=st.width)
    b_ms, b_out = event_ms(lambda: perturb_cuda.perturb_dist(st.table, st.P, st.n_steps,
                                                             **bkw))
    b_ref, b_plain = sync_time(lambda: perturb_cuda.perturb_dist_plain(
        st.table, st.P, st.n_steps, **bkw))
    print(f"kernel B p32 3000x3000/4000 on {card}: {b_ms:.3f} ms; plain "
          f"{b_plain * 1e3:.3f} ms", flush=True)
    compare(f"kernel B p32 3000x3000/4000 P[8]={int(st.P[8].item())}", b_out, b_ref,
            record, "perturb_dist")
    # each kernel's work in pixel-steps (a pixel's steps are its count plus
    # its escape step; kernel B starts at n0 = P[8]; kernel A is counted
    # without periodicity, whose early freezes hide steps)
    nokw = {**akw, "periodicity": False}
    a_off_ms, a_off = event_ms(lambda: escape_cuda.iterate_params(params, **nokw))
    cnt = a_off[2].long()
    a_steps = int((cnt + (cnt < exact.iterations).long()).sum())
    d, cnt = b_out
    esc = (d > float(exact.limit) ** 2).long()
    b_steps_n = int((cnt.long() + esc - int(st.P[8].item())).clamp(min=0).sum())
    print(f"kernel A ds32, periodicity off: {a_steps} pixel-steps in {a_off_ms:.3f} ms "
          f"= {a_steps / a_off_ms / 1e6:.2f} G steps/s; kernel B: {b_steps_n} pixel-steps "
          f"in {b_ms:.3f} ms = {b_steps_n / b_ms / 1e6:.2f} G steps/s", flush=True)
    print_efficiency("kernel B dist-only headline p32",
                     (cnt.long() + esc - int(st.P[8].item())).clamp(min=0))
    for tier, sc in scenes.items():
        p_img, t_plain = sync_time(lambda: headline_plain_route(sc, escape_cuda, perturb,
                                                                perturb_cuda, render))
        eq = bits_equal(images[tier], p_img)
        print(f"headline {tier} plain route on {card}: {t_plain * 1e3:.3f} ms; "
              f"3000x3000 kernel route == plain route: {eq}", flush=True)
        check(eq, f"{tier}: the main path's image differs from the plain route's")
    del images
    # kernel route vs plain route, whole image, at 1000x1000 of the same view
    for tier, sc in scenes.items():
        small = sc.replace(width=1000, height=1000)
        k_img = render.render_u8(small, DEVICE)
        p_img = headline_plain_route(small, escape_cuda, perturb, perturb_cuda, render)
        eq = bits_equal(k_img, p_img)
        print(f"headline view {tier} 1000x1000: kernel route == plain route: {eq}",
              flush=True)
        check(eq, f"{tier}: the kernel route's image differs from the plain route's")

    # 6. the deep path (counters zeroed just before, read just after)
    zero_counters(escape_cuda, perturb_cuda)
    deep = phase_deep(Scene, render, perturb, native_walk, card)
    deep_launches = counters(escape_cuda, perturb_cuda)
    print(f"launch counters after the deep renders: {deep_launches}", flush=True)
    check(deep["dz1e12"][3] is not None, "dz1e12: no multiref reference resolved a pixel")
    check(deep_launches["perturb_full"] > 0 and deep_launches["perturb_points"] > 0,
          "a kernel of the deep path never launched")

    # 7. the same orchestration on the plain versions (p1e15 only while the
    # run stays inside half its time limit)
    names = ["dz1e12"]
    if time.perf_counter() - t_start < 400:
        names.append("p1e15")
    else:
        print("p1e15 plain-route check skipped: the run is past 400 s", flush=True)
    phase_deep_plain(perturb, deep, card, names)

    # 8. the ds32 fallback on kernel A's points form
    fallback_scene, fb_launches = phase_ds32_fallback(Scene, render, perturb, perturb_cuda,
                                                      escape_cuda, card)

    # 9. the deep-path kernels at their main-path shapes
    timing = phase_deep_timing(Scene, perturb, perturb_cuda, escape_cuda, _cuda_build,
                               fallback_scene, deep, record, card)

    # 10. kernel D against its plain version
    phase_kernel_d(Scene, perturb, perturb_cuda, record, card)

    # 11. the floatexp path (counters zeroed just before, read just after)
    zero_counters(escape_cuda, perturb_cuda)
    extreme = phase_deep(Scene, render, perturb, native_walk, card,
                         views=(("fe1e44", FE1E44), ("fe1e44_11k", FE1E44_11K)),
                         tier="floatexp", route="kernel D")
    fe_launches = counters(escape_cuda, perturb_cuda)
    print(f"launch counters after the floatexp renders: {fe_launches}", flush=True)
    check(extreme["fe1e44"][3] is not None, "fe1e44: no multiref reference resolved a pixel")
    check(fe_launches["perturb_fe_full"] > 0 and fe_launches["perturb_fe_points"] > 0,
          "a kernel of the floatexp path never launched")

    # 12. the fe BLA kernel and the p32 tier past 1e30x
    bla_launches, bla_img = phase_bla_and_p32(Scene, render, perturb, perturb_cuda,
                                              escape_cuda, card)
    timing["perturb_bla_fe"] = phase_bla_kernel_in(root, Scene, tiled, perturb, perturb_cuda,
                                                   record, card, bla_img)
    del bla_img

    # 13. the same orchestration on the plain versions, at a crop of fe1e44
    phase_plain_crop(Scene, render, perturb, card, "fe1e44", FE1E44, FE_PLAIN_CROP)

    # 14. kernel D at its main-path shapes
    timing.update(phase_fe_timing(Scene, perturb, perturb_cuda, extreme["fe1e44"][3], record,
                                  card, timing["sm_clock_mhz"]))

    # 15. kernel H against its plain version
    phase_kernel_h(fern_hist, hist_cuda, record)

    # 16. the fern path (kernel H's counter zeroed just before, read just after)
    h_launches = phase_fern(scene_defaults, render, fern, hist_cuda, threefry, card)

    # 17. kernel H at its main-path launch, beside PyTorch's own calls
    h_timing = phase_h_timing(fern, fern_hist, hist_cuda, record, card)

    # 18-20. the probe entry point and kernels G, F and E
    probe_launches, probe_timing = phase_probes(lean_probe, probe_cuda, perturb_cuda, record,
                                                card)
    timing.update(probe_timing)

    # 21. sweeps
    sweep_f32_launches = phase_sweeps(Scene, animate, render, perturb, escape_cuda,
                                      perturb_cuda, card)

    # 22. banded renders (checkpoints under build/, which git ignores)
    ckpt_root = os.path.join(root, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        phase_bands(Scene, tiled, render, perturb, escape_cuda, perturb_cuda, card, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)

    # 23. kernel A's grid forms against their plain versions, its f32 forms
    # alone, the epilogue's libdevice calls
    phase_a_cases(Scene, escape_cuda, record)
    a_f32 = phase_a_f32_timing(Scene, animate, render, escape_cuda, _cuda_build, record, card)
    phase_math_probe(escape_cuda, card)

    # 24. bench.py's rows on kernel A's f32 form
    phase_rows(Scene, render, escape_cuda, perturb_cuda, card)

    # 25. f64 words: kernel A's dd64 form and the f64 kernel
    t25 = time.perf_counter()
    a_times = phase_f64_cases(Scene, escape, escape_cuda, viewport, record)
    f64_dev = phase_f64_device_times(root)
    f64_words = phase_f64_words(Scene, render, tiled, animate, escape, escape_cuda, viewport,
                                deep["dz1e12"][1], a_times, f64_dev, card, record)
    print(f"phase 25: {time.perf_counter() - t25:.1f} s", flush=True)

    # 26. the viewer, --trace and --backend; the f32 grid loop's two forms;
    # kernel A's points form on the device
    f32_grid, dev26 = phase_viewer_and_flags(Scene, render, viewer, cli, escape, escape_cuda,
                                             perturb, perturb_cuda, hist_cuda, native_walk,
                                             viewport, root, card, record)
    # 27. the device mesh: logical meshes on this card, the viewer, the CLI
    # and two ranks over gloo
    from fractal_tpu_torch.parallel import sharding

    phase_mesh(Scene, scene_defaults, render, animate, tiled, viewer, sharding, escape,
               escape_cuda, perturb, perturb_cuda, hist_cuda, root, card)

    # 28. the CPU's f32 BLA route beside the card's
    phase_cpu_route(Scene, render, perturb, escape_cuda, perturb_cuda, card)

    pts = timing["escape_points"]
    pts_ms, pts_by = ms_and_source(dev26["escape_points"], pts[0])
    print(f"kernel A points, 1e8 flagged list on {card}: {pts_ms!r} ms by the {pts_by} "
          f"({pts[0]:.4f} by events), bound {pts[2]:.4f} ms by {pts[3]} "
          f"({pts[2] / pts_ms:.3f} of it), latency floor {timing['escape_points_floor']:.4f} ms "
          f"({timing['escape_points_floor'] / pts_ms:.3f} of it)", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    n_px = exact.height * exact.width
    a_bound = bound_ms(a_steps * OPS_A_DS32 + a_color_ops,
                       64 + 4 * escape_cuda.COLOR_FIELDS + n_px * 3)
    b_bound = bound_ms(b_steps_n * OPS_B_DIST, st.table.numel() * 4 + 64 + n_px * 8)
    kernels = [
        dict(name="escape_time", source=A_SRC, replaces=A_REPLACES,
             launches=head_launches["escape_time"], ms=a_ms, plain_ms=a_plain * 1e3,
             bound=a_bound),
        dict(name="escape_time_f32", source=A_SRC, replaces=A_REPLACES,
             launches=sweep_f32_launches, ms=a_f32[0], ms_by=a_f32[1], plain_ms=a_f32[2],
             bound=a_f32[3:]),
        dict(name="escape_points", source=A_SRC, replaces=A_POINTS_REPLACES,
             launches=fb_launches["escape_points"], ms=pts_ms, ms_by=pts_by,
             plain_ms=pts[1], bound=pts[2:]),
        dict(name="perturb_dist", source=B_SRC, replaces=B_REPLACES,
             launches=head_launches["perturb_dist"], ms=b_ms, plain_ms=b_plain * 1e3,
             bound=b_bound),
        dict(name="perturb_full", source=B_SRC, replaces=B_REPLACES,
             launches=deep_launches["perturb_full"], ms=timing["perturb_full"][0],
             plain_ms=timing["perturb_full"][1], bound=timing["perturb_full"][2:]),
        dict(name="perturb_points", source=B_SRC, replaces=C_REPLACES,
             launches=deep_launches["perturb_points"], ms=timing["perturb_points"][0],
             plain_ms=timing["perturb_points"][1], bound=timing["perturb_points"][2:]),
        dict(name="perturb_fe_full", source=D_SRC, replaces=D_REPLACES,
             launches=fe_launches["perturb_fe_full"], ms=timing["perturb_fe_full"][0],
             plain_ms=timing["perturb_fe_full"][1], bound=timing["perturb_fe_full"][2:]),
        dict(name="perturb_fe_points", source=D_SRC, replaces=D_REPLACES,
             launches=fe_launches["perturb_fe_points"], ms=timing["perturb_fe_points"][0],
             plain_ms=timing["perturb_fe_points"][1], bound=timing["perturb_fe_points"][2:]),
        dict(name="perturb_bla_fe", source=BLA_SRC, replaces=BLA_REPLACES, launches=bla_launches,
             **timing["perturb_bla_fe"]),
        dict(name="hist", source=H_SRC, replaces=H_REPLACES, launches=h_launches,
             ms=h_timing[0], plain_ms=h_timing[1], bound=h_timing[2:4], library=h_timing[4]),
        dict(name="chain", source=G_SRC, replaces=G_REPLACES,
             launches=probe_launches["chain"], ms=timing["chain"][0],
             plain_ms=timing["chain"][1], bound=timing["chain"][2:]),
        dict(name="probe", source=F_SRC, replaces=F_REPLACES,
             launches=probe_launches["probe"], ms=timing["probe"][0],
             plain_ms=timing["probe"][1], bound=timing["probe"][2:]),
        dict(name="perturb_packed", source=B_SRC, replaces=E_REPLACES,
             launches=probe_launches["perturb_packed"], ms=timing["perturb_packed"][0],
             plain_ms=timing["perturb_packed"][1], bound=timing["perturb_packed"][2:]),
        dict(name="escape_time_dd64", source=A64_SRC, replaces=DD64_REPLACES,
             **f64_words["escape_time_dd64"]),
        dict(name="escape_time_f64", source=A64_SRC, replaces=GRID_REPLACES,
             **f64_words["escape_time_f64"]),
        dict(name="escape_time_f32_grid", source=A64_SRC, replaces=GRID_REPLACES,
             **f32_grid["escape_time_f32_grid"]),
        dict(name="escape_time_f32_grid_color", source=A64_SRC, replaces=GRID_REPLACES,
             **f32_grid["escape_time_f32_grid_color"]),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": record[k["name"]], "ms": k["ms"],
         "ms_by": k.get("ms_by", "events"), "plain_ms": k["plain_ms"],
         "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
         "library_ms": k.get("library"), **k.get("extra", {})}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
