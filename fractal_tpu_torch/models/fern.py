"""Barnsley fern, the batched chaos game (port of
``fractal_tpu/models/fern.py``).

Reference semantics (src/lib.rs:418-463 ``fern``, 392-408
``subtract_pixel``, 271-319 replicate-and-reduce):

  * start point (pos.re·W, pos.im·H);
  * empirical geometry: effective_scale_x = 65·scale.re·H·0.006,
    effective_scale_y = 37·scale.im·H·0.006, x-offset W/2, y formula
    ``H − ((y + (pos.im − 5.0) − 0.5)·esy + H/2)``;
  * affine branches with Wikipedia coefficients chosen by a uniform draw at
    thresholds .01/.86/.93;
  * each hit multiplies the pixel by the per-channel darkening factor,
    truncating to u8 every time, so the value after n hits is a precomputed
    decay curve indexed by n (``darkening_curve``);
  * N replicas render N independent ferns with iterations/N each and
    combine them with per-pixel saturating adds.

K independent walkers run iterations/K steps each.  The walk's random
numbers are ``ops/threefry``'s, bit-equal to the JAX package's
``jax.random`` stream: per replica the key ``fold_in(PRNGKey(seed), rep)``,
one ``split`` per step (burn-in steps included), one uniform per walker
from each subkey.  The key chain never depends on the walkers, so it is
walked on the host first; the uniforms and the branch coefficients are then
formed for ``STEP_BATCH`` steps in one batch of tensor operations, only the
affine update itself runs step by step, and the batch's plot indices go to
the histogram (kernel H, ``ops/hist_cuda``) in one call.  Integer adds
commute, so the histogram does not depend on how many steps a call holds.

The mesh's exact mode (``parallel/sharding.render_fern_sharded``) walks
slices of one walker set: ``lo`` is the slice's first walker, whose
uniforms are elements lo, lo + 1, ... of the full-width stream.  The
reference draws the stream full-width and slices it (its ``rng_walkers``,
with padding walkers that walk but never plot); ``ops/threefry`` hashes
each element's counter alone, so a slice is drawn on its own and needs no
padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.ops import hist_cuda, threefry
from fractal_tpu_torch.utils.timing import span

# Affine maps (a, b, c, d, e, f): x' = a·x + b·y + e ; y' = c·x + d·y + f
# Thresholds on the uniform draw r: branch 0 if r < .01, 1 if < .86,
# 2 if < .93, else 3 (src/lib.rs:445-461, Wikipedia coefficients).
_FERN_COEFFS = np.array(
    [
        [0.00, 0.00, 0.00, 0.16, 0.0, 0.00],
        [0.85, 0.04, -0.04, 0.85, 0.0, 1.60],
        [0.20, -0.26, 0.23, 0.22, 0.0, 1.60],
        [-0.15, 0.28, 0.26, 0.24, 0.0, 0.44],
    ],
    dtype=np.float32,
)
_THRESHOLDS = np.array([0.01, 0.86, 0.93], dtype=np.float32)

DEFAULT_WALKERS = 65536

#: Steps whose uniforms, coefficients and plot indices are formed in one
#: batch, and whose indices reach the histogram in one call (where the JAX
#: package's scan has its SCATTER_BATCH).
STEP_BATCH = 64

#: The fern's span sink (``utils/timing.span``): None, or a list to which
#: every step of a render appends (kind, detail, ms), fenced with
#: ``torch.cuda.synchronize()`` where it is a ``timing.Fenced`` list.
SPLIT = None
#: The most recent fern render: points walked, histogram calls, and whether
#: the histogram ran on kernel H or on its plain version.
RENDER_STATS = {"tier": "", "route": "", "points": 0, "hist_calls": 0}


def _step(kind: str, detail: str = ""):
    return span(SPLIT, kind, detail)


def _burn_in(scene: Scene, width: int, height: int) -> int:
    """Steps walked but not plotted while walkers settle onto the attractor.

    The reference's single walker plots its transient (invisible in 10M
    points), but K parallel walkers all start at the same (pos.re·W,
    pos.im·H) and would amplify it K-fold into a solid artifact.  The
    slowest IFS contraction is 0.85/step, so burn until the start distance
    shrinks below a tenth of a pixel, plus a safety margin."""
    d = max(abs(scene.pos[0]) * width, abs(scene.pos[1]) * height, 1.0)
    return 16 + int(math.log(10.0 * d) / math.log(1.0 / 0.85))


def darkening_curve(background, primary, weight: float) -> np.ndarray:
    """Pixel value after n hits, for n = 0..cycle, shape (L, 3) uint8.

    Exact n-fold composition of the reference's per-hit darkening
    (src/lib.rs:399-406).  The darkened channels are fed back through the
    swapped ``RGB::new(r, b, g)`` constructor (calc/src/lib.rs:129), so one
    hit writes, in true (r, g, b) field order:

        r ← trunc(r · f(v.r));  g ← trunc(b · f(v.b));  b ← trunc(g · f(v.g))

    i.e. new = u8(swap_gb(p · factors)) — the g/b channels alternate across
    hits.  The sequence always lands on a 2-cycle (a fixed point is a
    2-cycle with equal entries): the two-step map is monotone nonincreasing
    per channel under truncation.  The returned curve ends exactly one full
    2-cycle from the end — entry n for n ≥ L is curve[L-2 + (n-(L-2)) % 2]
    (see ``apply_darkening``).
    """
    v = np.array(primary, dtype=np.float64)
    factors = np.empty(3)
    for c in range(3):
        if v[c] <= 0.0:
            factors[c] = 0.0  # 1/(v/255) → ∞ in Rust f64 ⇒ multiply by 0
        else:
            factors[c] = 1.0 / (((1.0 / (v[c] / 255.0)) - 1.0) * weight + 1.0)

    def step(p):
        q = p.astype(np.float64) * factors
        q = np.where(np.isnan(q), 0.0, q)
        q = np.clip(np.trunc(q), 0.0, 255.0)
        return q[[0, 2, 1]].astype(np.uint8)  # RGB::new's g/b swap

    curve = [np.array([int(b) for b in background], dtype=np.uint8)]
    for _ in range(1024):
        q = step(curve[-1])
        if len(curve) >= 2 and np.all(q == curve[-2]):
            break  # 2-cycle closed (covers the fixed point: q == both tails)
        curve.append(q)
    if len(curve) < 2 or not np.all(step(curve[-1]) == curve[-2]):
        curve.append(step(curve[-1]))  # ensure the last two entries cycle
    return np.stack(curve)  # (L, 3)


def lut_index(hits, length: int):
    """Map hit counts to darkening-curve rows, extending past the end with
    the curve's terminal 2-cycle (parity of n)."""
    tail = length - 2 + torch.remainder(hits - (length - 2), 2)
    return torch.where(hits < length, hits, tail)


class _Geometry:
    """The walk's f32 scalars, formed in the JAX package's order."""

    def __init__(self, scene: Scene, width: int, height: int):
        f32 = np.float32
        self.width, self.height = width, height
        w_f, h_f = f32(width), f32(height)
        self.pos_re, self.pos_im = f32(scene.pos[0]), f32(scene.pos[1])
        self.esx = f32(65.0) * f32(scene.scale[0]) * h_f * f32(0.006)
        self.esy = f32(37.0) * f32(scene.scale[1]) * h_f * f32(0.006)
        self.x0 = self.pos_re * w_f
        self.y0 = self.pos_im * h_f
        self.half_w = w_f / f32(2.0)
        self.half_h = h_f / f32(2.0)
        self.h_f = h_f
        self.y_shift = self.pos_im - f32(5.0)


def plot_indices(geo: _Geometry, x, y):
    """Flat pixel index of each walker (src/lib.rs:433-437) with Rust's
    ``as usize`` cast: truncate toward zero, negatives to 0; points off the
    image get the drop sentinel W·H."""
    width, height = geo.width, geo.height
    px_f = (x - float(geo.pos_re)) * float(geo.esx) + float(geo.half_w)
    py_f = float(geo.h_f) - ((y + float(geo.y_shift) - 0.5) * float(geo.esy)
                             + float(geo.half_h))
    # the upper clamp keeps the cast to int32 defined far off the image
    px = torch.trunc(px_f).clamp_(0.0, 2147483520.0).to(torch.int32)
    py = torch.trunc(py_f).clamp_(0.0, 2147483520.0).to(torch.int32)
    valid = (px < width) & (py < height)
    return torch.where(valid, py * width + px, width * height)


def _branch_coefficients(r):
    """The per-walker affine coefficients for uniforms ``r`` (s, k): the
    select chain on r >= .01/.86/.93 with the f32 constants, stacked as
    A = [a, c], B = [b, d], E = [e, f], each (s, 2, k), so that
    (x', y') = A·x + B·y + E."""
    masks = [r >= float(t) for t in _THRESHOLDS]

    def pick(j):
        c = _FERN_COEFFS
        v = torch.full_like(r, float(c[0, j]))
        for m, row in zip(masks, (1, 2, 3)):
            v = torch.where(m, float(c[row, j]), v)
        return v

    ca, cb, cc, cd, ce, cf_ = (pick(j) for j in range(6))
    return (torch.stack((ca, cc), 1), torch.stack((cb, cd), 1),
            torch.stack((ce, cf_), 1))


def walk_stream(scene: Scene, width: int, height: int, walkers: int, steps: int,
                seed: int, burn_in: int = 64, *, replica: int = 0, device="cuda",
                lo: int = 0):
    """Yield the walk's plot indices batch by batch: int32 (b, walkers)
    tensors on ``device`` covering the ``steps`` plotted steps after
    ``burn_in`` unplotted ones, each step plotted before its update; the
    walkers are walkers lo .. lo + walkers − 1 of a wider set."""
    geo = _Geometry(scene, width, height)
    k, step_batch = walkers, STEP_BATCH
    total = burn_in + steps
    with _step("key chain", f"{total} splits on the host"):
        subkeys = threefry.key_chain(int(seed), int(replica), total)
    xy = torch.empty((min(step_batch, total) + 1, 2, k), dtype=torch.float32, device=device)
    xy[0, 0] = float(geo.x0)
    xy[0, 1] = float(geo.y0)
    for g0 in range(0, total, step_batch):
        b = min(step_batch, total - g0)
        with _step("uniforms", f"{b} steps x {k} walkers"):
            r = threefry.uniform(subkeys[g0:g0 + b], k, device, lo)
            A, B, E = _branch_coefficients(r)
        with _step("walk", f"{b} steps"):
            for i in range(b):
                # nx = ca·x + cb·y + ce, left to right, each product rounded
                t = A[i] * xy[i, 0]
                t += B[i] * xy[i, 1]
                torch.add(t, E[i], out=xy[i + 1])
        first = max(burn_in - g0, 0)  # the batch's first plotted step
        if first < b:
            with _step("plot indices", f"{b - first} steps"):
                idx = plot_indices(geo, xy[first:b, 0], xy[first:b, 1])
            yield idx
        xy[0] = xy[b]


def fern_hits(scene: Scene, width: int, height: int, walkers: int, steps: int,
              replicas: int, seed: int, burn_in: int = 64, *, device="cuda",
              histogram=hist_cuda.hist_accumulate, lo: int = 0):
    """Run the chaos game; return per-replica hit-count grids
    (replicas, H, W) int32 on ``device``.  ``histogram(idx, hist)`` adds a
    batch's indices into the replica's bins: kernel H, or its plain version
    where a caller compares the two.  ``lo`` (``walk_stream``) makes the
    walkers a slice of a wider set, whose slices' hits sum to its own."""
    hits = torch.zeros((replicas, height * width), dtype=torch.int32, device=device)
    calls = 0
    for rep in range(replicas):
        for idx in walk_stream(scene, width, height, walkers, steps, seed, burn_in,
                               replica=rep, device=device, lo=lo):
            with _step("histogram", f"{idx.numel()} points"):
                histogram(idx, hits[rep])
            calls += 1
    RENDER_STATS.update(points=replicas * steps * walkers, hist_calls=calls)
    return hits.reshape(replicas, height, width)


def apply_darkening(hits, curve: np.ndarray):
    """hits (…, H, W) int32 → image (…, H, W, 3) uint8 via the decay curve,
    alternating over the terminal 2-cycle for counts past the curve end."""
    lut = torch.from_numpy(np.ascontiguousarray(curve)).to(hits.device)  # (L, 3)
    return lut[lut_index(hits, lut.shape[0]).long()]


def saturating_sum_u8(imgs):
    """Per-pixel saturating add across the leading axis — the reference's
    ``combine_images`` all-reduce (src/lib.rs:272-318)."""
    total = imgs.to(torch.int32).sum(dim=0)
    return total.clamp_(max=255).to(torch.uint8)


def walk_plan(scene: Scene, walkers: int = DEFAULT_WALKERS):
    """(replicas, walkers, steps) of a render: the point budget split over
    the replicas, walked by at most ``walkers`` walkers."""
    replicas = max(1, scene.fern_replicas)
    per_replica = max(1, max(1, scene.iterations) // replicas)
    k = int(min(walkers, per_replica))
    return replicas, k, max(1, per_replica // k)


def scene_curve(scene: Scene) -> np.ndarray:
    """The scene's ``darkening_curve``."""
    return darkening_curve(scene.secondary_color.as_tuple(),
                           scene.primary_color.as_tuple(), float(scene.color_weight))


def render_fern(scene: Scene, device, walkers: int = DEFAULT_WALKERS,
                histogram=hist_cuda.hist_accumulate):
    """Full fern render on ``device``: chaos game → hit histogram →
    darkening curve → (optional) replica saturating-sum.  ``supersample=k``
    plots onto a k× grid and box-downsamples the darkened image."""
    replicas, k, steps = walk_plan(scene, walkers)
    ss = scene.supersample
    w, h = scene.width * ss, scene.height * ss
    device = torch.device(device)
    on_kernel = histogram is hist_cuda.hist_accumulate and device.type == "cuda"
    RENDER_STATS.update(tier="fern", route="kernel H" if on_kernel else "plain")

    hits = fern_hits(scene, w, h, k, steps, replicas, scene.seed,
                     burn_in=_burn_in(scene, w, h), device=device, histogram=histogram)
    return darken(scene, hits)


def darken(scene: Scene, hits):
    """The image of per-replica hit grids (replicas, H·ss, W·ss): each
    replica darkened, the replicas' saturating sum, the box downsample."""
    replicas, ss = hits.shape[0], scene.supersample
    with _step("darkening", f"{replicas} replica(s)"):
        curve = scene_curve(scene)
        if replicas == 1:
            img = apply_darkening(hits[0], curve)
        else:
            img = saturating_sum_u8(apply_darkening(hits, curve))  # (R,H,W,3)→
        if ss > 1:
            from fractal_tpu_torch.ops.coloring import downsample_box

            img = downsample_box(img.to(torch.float32), ss)
    return img
