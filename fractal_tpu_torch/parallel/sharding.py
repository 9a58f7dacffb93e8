"""The device mesh (port of ``fractal_tpu/parallel/sharding.py``).

The reference's two parallel strategies (SURVEY.md §2 C7/C9):

* **Rows interleaved across the shards.**  Shard d of n renders global
  rows d, d + n, d + 2n, ... of the image (of a band: start + d, ...):
  escape-time cost varies across the image and neighbouring rows cost
  alike, so striding evens the shards' work.  The stripe's rows ride the
  global-row maps the kernels already have, kernel A's block [14:16]
  (stride, offset) and kernels B and D's ``P[6:8]``; the stripes are
  interleaved on the mesh's first device and the padding rows cropped, so
  the image is the one-device render's bit for bit.
* **The fern's walkers sliced across the shards**, their integer hit
  grids summed (the reference's ``psum``): bit-equal to one device.  The
  ensemble and compat-replica modes run a seeded replica a shard.

A ``Mesh`` is an ordered tuple of ``torch.device``, one a shard.  A device
may appear more than once: ``Mesh((torch.device("cuda", 0),) * 4)`` is four
shards on one card, each its own launches, which is how one card (and the
CPU) runs the sharded code.  Shards on distinct GPUs each launch on their
own device before any stripe is gathered.  Under ranks
(``parallel/multihost``) the mesh spans every rank's devices in rank order;
a rank renders its own shards, and the stripes travel over gloo on host
copies.  A shard runs where its device says: nothing here moves one to
the CPU, and a launch that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from fractal_tpu_torch.config import Scene
from fractal_tpu_torch.parallel import multihost

#: Shards of ``make_mesh()`` on the CPU (the JAX package's tests force 8
#: host devices): what ``--devices 0`` takes there.
CPU_SHARDS = 8


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One shard per entry of ``devices``; ``ranks[i]`` is the rank that
    renders shard i (all of them this process's by default), ``rank`` this
    process's."""

    devices: Tuple[torch.device, ...]
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        ranks = (self.rank,) * len(devices) if self.ranks is None else tuple(self.ranks)
        if not devices or len(ranks) != len(devices):
            raise ValueError("a mesh needs one rank for each of its one or more devices")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices are of one type, not {devices}")
        object.__setattr__(self, "ranks", ranks)
        if not self.local:
            raise ValueError(f"rank {self.rank} renders no shard of this mesh")
        local = tuple(_norm(d) if r == self.rank else d for d, r in zip(devices, ranks))
        object.__setattr__(self, "devices", local)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process renders."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)

    @property
    def home(self) -> torch.device:
        """Where this process gathers: its first shard's device."""
        return self.devices[self.local[0]]

    @property
    def spans_ranks(self) -> bool:
        return len(set(self.ranks)) > 1


def local_devices(device="cuda") -> Tuple[torch.device, ...]:
    """This process's devices of ``device``'s type: every CUDA device, or
    ``CPU_SHARDS`` CPU shards."""
    from fractal_tpu_torch.render import _device

    device = _device(device)
    if device.type == "cpu":
        return (device,) * CPU_SHARDS
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(n_devices: Optional[int] = None, device="cuda", local=None) -> Mesh:
    """The first ``n_devices`` shards (all by default) of this process's
    devices, ``local`` (default ``local_devices(device)``); under ranks, of
    every rank's in rank order, each rank keeping at least one."""
    local = tuple(local) if local is not None else local_devices(device)
    ranks = (0,) * len(local)
    rank = multihost.process_index()
    if multihost.is_multihost():
        import torch.distributed as dist

        every = [None] * multihost.process_count()
        dist.all_gather_object(every, [str(d) for d in local])
        local = tuple(torch.device(d) for devs in every for d in devs)
        ranks = tuple(r for r, devs in enumerate(every) for _ in devs)
    n = len(local) if n_devices is None else n_devices
    if not 0 < n <= len(local):
        raise ValueError(f"a mesh of {n} shards from {len(local)} device(s)")
    mesh = Mesh(local[:n], ranks[:n], rank)
    if mesh.spans_ranks and len(set(mesh.ranks)) != multihost.process_count():
        raise ValueError(f"a mesh of {n} shards leaves a rank without one")
    return mesh


def mesh_for_devices(devices: int, device="cuda") -> Optional[Mesh]:
    """The ``--devices N`` mesh: None for 1 (the one-device path), every
    device for 0, an error past the device count."""
    if devices < 0:
        raise ValueError(f"--devices {devices}: must be >= 0 (0 = all)")
    if devices == 1:
        return None
    avail = len(local_devices(device)) * multihost.process_count()
    n = avail if devices == 0 else devices
    if n > avail:
        raise ValueError(f"--devices {n}: only {avail} device(s) available")
    return make_mesh(n, device)


# ---------------------------------------------------------------------------
# Launch on every shard, then gather
# ---------------------------------------------------------------------------


def _on(device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _per_shard(mesh: Mesh, fn: Callable) -> Dict[int, object]:
    """``fn(d, device)`` for each of this process's shards d, under its
    device, all launched before any result is read."""
    out = {}
    for d in mesh.local:
        with _on(mesh.devices[d]):
            out[d] = fn(d, mesh.devices[d])
    return out


def _gather(mesh: Mesh, parts: Dict[int, torch.Tensor]):
    """Each shard's tensor (one shape for all) on the mesh's home device,
    in shard order: this process's copied over, other ranks' all-gathered
    on host copies."""
    home = mesh.home
    if not mesh.spans_ranks:
        return [parts[d].to(home) for d in range(mesh.size)]
    import torch.distributed as dist

    owned = [[d for d in range(mesh.size) if mesh.ranks[d] == r]
             for r in range(multihost.process_count())]
    cap = max(len(o) for o in owned)
    local = torch.stack([parts[d].cpu() for d in mesh.local])
    if local.shape[0] < cap:
        local = torch.cat([local, local.new_zeros((cap - local.shape[0],) + local.shape[1:])])
    bufs = [torch.empty_like(local) for _ in owned]
    dist.all_gather(bufs, local)
    out = [None] * mesh.size
    for buf, shards in zip(bufs, owned):
        for j, d in enumerate(shards):
            out[d] = buf[j].to(home)
    return out


def _interleave(mesh: Mesh, parts: Dict[int, object], rows: int):
    """The stripes of each shard (a tensor or a tuple of them, each
    (rows_local, ...)) as the (rows, ...) image: row r from shard r mod n."""
    def one(stripes):
        return torch.stack(stripes, 1).reshape((-1,) + stripes[0].shape[1:])[:rows]

    first = parts[mesh.local[0]]
    if isinstance(first, tuple):
        return tuple(one(_gather(mesh, {d: p[i] for d, p in parts.items()}))
                     for i in range(len(first)))
    return one(_gather(mesh, parts))


def _sum(mesh: Mesh, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The shards' integer tensors summed on the home device (across ranks
    by an all-reduce on a host copy)."""
    total = None
    for d in mesh.local:
        p = parts[d].to(mesh.home)
        total = p if total is None else total + p
    if mesh.spans_ranks:
        import torch.distributed as dist

        host = total.cpu()
        dist.all_reduce(host)
        total = host.to(mesh.home)
    return total


def _row_blocks(mesh: Mesh, block: torch.Tensor, field: int, start: int) -> dict:
    """``block`` (a host parameter vector) with the global-row map
    [field, field + 1] = (n, start + d) for each shard d, uploaded once to
    each device this process uses: {d: shard d's row}."""
    n = mesh.size
    rows = block.repeat(n, 1)
    rows[:, field] = float(n)
    rows[:, field + 1] = torch.arange(n, dtype=rows.dtype) + float(start)
    on = {}
    for d in mesh.local:
        dev = mesh.devices[d]
        if dev not in on:
            on[dev] = rows.to(dev)
    return {d: on[mesh.devices[d]][d] for d in mesh.local}


# ---------------------------------------------------------------------------
# Escape time: rows interleaved
# ---------------------------------------------------------------------------


def unsupported_precision(precision: str) -> ValueError:
    return ValueError(
        f"sharded rendering supports f32/ds32/perturb, not {precision!r}; use "
        f"precision='ds32' (f64-grade) or 'perturb' for deeper zooms")


def render_escape_sharded(scene: Scene, mesh: Optional[Mesh] = None,
                          precision: Optional[str] = None, backend: str = "auto"):
    """An escape-time scene across ``mesh`` (default: every device) → the
    (height, width, 3) uint8 image on the mesh's home device, bit-equal to
    ``render_u8(scene, home, backend)``.  The perturbation tiers go to
    ``render_perturb_sharded``; f64 and dd64 are refused (the sharded
    kernels are kernel A's f32 and ds32 forms)."""
    from fractal_tpu_torch.render import BACKENDS, resolve_precision

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from {BACKENDS})")
    mesh = mesh if mesh is not None else make_mesh()
    precision = precision or resolve_precision(scene, mesh.home)
    if precision in ("perturb", "p32"):
        return render_perturb_sharded(scene, mesh, fast=precision == "p32")
    return render_escape_band_sharded(scene, 0, scene.height * scene.supersample,
                                      precision, mesh, backend)


def render_escape_band_sharded(scene: Scene, start_row: int, rows: int, precision: str,
                               mesh: Mesh, backend: str = "auto"):
    """Global rows [start_row, start_row + rows) of the supersampled grid at
    f32 or ds32, interleaved across ``mesh`` → (rows / supersample, width,
    3) uint8 on its home device.  The route is the one-device render's
    (``render._render_escape``): the grid route at f32 with ``backend``
    "jnp", or "auto" on the CPU, each stripe's ``pixel_grid`` strided; else
    kernel A with block [14:16] = (n, start_row + d), at supersample 1 its
    colored form, above it the three-output form, colored and averaged in
    torch after the interleave."""
    from fractal_tpu_torch.ops import escape_cuda, viewport
    from fractal_tpu_torch.ops.escape import iterate_grid
    from fractal_tpu_torch.render import _GRID_KERNELS, RENDER_STATS, _color_and_downsample

    if precision not in escape_cuda.PRECISIONS:
        raise unsupported_precision(precision)
    n, ss = mesh.size, scene.supersample
    rows_local = -(-rows // n)
    w, h = scene.width * ss, scene.height * ss
    on_card = mesh.home.type != "cpu"
    grid = precision == "f32" and (backend == "jnp" or (backend == "auto" and not on_card))
    if grid:
        kw = dict(algo=scene.algo, power=scene.power, iterations=scene.iterations,
                  limit=scene.limit,
                  julia_set=scene.julia_set if scene.algo == "julia" else None)

        def stripe(d, dev):
            cr, ci = viewport.pixel_grid(w, h, scene.pos, scene.scale, device=dev,
                                         row0=start_row + d, rows=rows_local, stride=n)
            return iterate_grid(cr, ci, **kw)

        route = (_GRID_KERNELS["f32"] if on_card
                 else "f32 grid, plain version (ops/escape.iterate)")
        colored = False
    else:
        colored = ss == 1
        block = torch.cat([escape_cuda.scene_params(scene, device="cpu"),
                           escape_cuda.color_params(scene, device="cpu")])
        blocks = _row_blocks(mesh, block, 14, start_row)
        kw = dict(algo=scene.algo, power=scene.power, iterations=scene.iterations,
                  precision=precision, height=rows_local, width=w,
                  periodicity=not scene.inside)

        def stripe(d, dev):
            params, color = blocks[d][:16], blocks[d][16:]
            if colored:
                return escape_cuda.iterate_color(params, color, inside=scene.inside,
                                                 smooth=scene.smooth, **kw)
            return escape_cuda.iterate_params(params, **kw)

        route = (f"kernel A {precision}{' colored' if colored else ''}"
                 + (" plain version" if not on_card else ""))
    out = _interleave(mesh, _per_shard(mesh, stripe), rows)
    RENDER_STATS["route"] = f"sharded {route}"
    return out if colored else _color_and_downsample(scene, *out)


# ---------------------------------------------------------------------------
# Perturbation: one orbit on every shard, rows interleaved
# ---------------------------------------------------------------------------


def _perturb_grids(mesh: Mesh):
    """``ops/perturb.Grids`` whose main grid is formed across ``mesh``: the
    view's orbit table, glitch column and P on each shard's device, with
    P[6:8] = (n, start + d), kernel B's glitch or dist-only form or kernel
    D's grid form on each stripe, or the view's BLA route (the fe table, or
    the f32 table on the CPU) on the whole stripe (one gate group: its skip
    gate a max over the stripe, as the reference's sharded route takes it,
    ROADMAP §3)."""
    from fractal_tpu_torch.ops import perturb as pt
    from fractal_tpu_torch.ops import perturb_cuda

    n = mesh.size

    def stripes(st, start, rows, fn):
        rows = st.height - start if rows is None else rows
        Ps = _row_blocks(mesh, st.P.cpu(), 6, start)
        return _interleave(mesh, _per_shard(mesh, lambda d, dev: fn(Ps[d], dev, -(-rows // n))),
                           rows)

    def main(scene, st, kernels, glitch, start=0, rows=None):
        def stripe(P, dev, rl):
            kw = dict(iterations=scene.iterations, height=rl, width=st.width)
            if st.bla is not None:  # the stripe is one gate group
                return pt._bla_route(kernels, st)(pt._packed_tensor(st.orbit, dev), P,
                                                  st.n_steps, pt._bla_tensor(st.bla, dev),
                                                  glitch=glitch, **kw)
            table, gtol = pt._orbit_tensors(st.orbit, dev)
            full = kernels.fe_full if st.extreme else kernels.full
            return full(table, gtol, P, st.n_steps, algo=scene.algo, power=scene.power,
                        glitch=glitch, **kw)

        return stripes(st, start, rows, stripe)

    def dist(scene, st, start, rows):
        def stripe(P, dev, rl):
            table, _ = pt._orbit_tensors(st.orbit, dev)
            return perturb_cuda.perturb_dist(table, P, st.n_steps, height=rl,
                                             width=st.width, algo=scene.algo,
                                             power=scene.power)

        return stripes(st, start, rows, stripe)

    return pt.Grids(main, dist, label="sharded ", key=("mesh", n))


def render_perturb_sharded(scene: Scene, mesh: Optional[Mesh] = None, fast: bool = False):
    """A perturbation render across ``mesh`` → (H, W, 3) uint8 on its home
    device: ``ops/perturb.render_perturb`` with the main grid's stripes on
    the shards, then, once on the gathered grid, the one-device render's
    resolve of its flagged pixels (kernel C's rounds, kernel A's points
    form, the direct resolve) and the coloring.  ``fast`` is the p32 tier,
    with the one-device semantics (no glitch test, no resolve)."""
    from fractal_tpu_torch.ops.perturb import render_perturb

    mesh = mesh if mesh is not None else make_mesh()
    return render_perturb(scene, mesh.home, fast=fast, grids=_perturb_grids(mesh))


def render_perturb_band_sharded(scene: Scene, start_row: int, rows: int,
                                fast: bool = False, mesh: Optional[Mesh] = None):
    """Global rows [start_row, start_row + rows) of a perturbation render
    across ``mesh`` (``ops/perturb.render_perturb_band``: P[7] = start_row
    + d, the flagged pixels resolved in global coordinates)."""
    from fractal_tpu_torch.ops.perturb import render_perturb_band

    mesh = mesh if mesh is not None else make_mesh()
    return render_perturb_band(scene, start_row, rows, mesh.home, fast=fast,
                               grids=_perturb_grids(mesh))


# ---------------------------------------------------------------------------
# The fern: walkers sliced, or a replica a shard
# ---------------------------------------------------------------------------


def render_fern_sharded(scene: Scene, mesh: Optional[Mesh] = None, walkers: int = None,
                        compat_replicas: bool = False, exact: bool = True):
    """The fern across ``mesh`` → (H, W, 3) uint8 on its home device, each
    shard's hits in its own bins on kernel H:

    * ``exact`` (default): shard d walks walkers [d·k, (d + 1)·k) of the
      one-device walker set, k = ceil(walkers / n), on the same uniform
      stream; the integer hits sum to ``render_fern``'s, bit for bit.
    * ``exact=False`` (ensemble): shard d walks its own replica, seed
      scene.seed + d·7919, with iterations / n points; the hits are summed
      and darkened once.
    * ``compat_replicas``: the reference's threads: each replica darkened on
      its own, then the saturating sum."""
    from fractal_tpu_torch.models import fern

    walkers = fern.DEFAULT_WALKERS if walkers is None else walkers
    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.size
    calls = []

    def hits_on(dev, *args, **kw):
        out = fern.fern_hits(scene, *args, device=dev, **kw)
        calls.append(fern.RENDER_STATS["hist_calls"])
        return out

    if exact and not compat_replicas:
        replicas, k_total, steps = fern.walk_plan(scene, walkers)
        k_dev = -(-k_total // n)
        ss = scene.supersample
        w, h = scene.width * ss, scene.height * ss
        burn = fern._burn_in(scene, w, h)

        def walker_slice(d, dev):
            k = min(k_dev, k_total - d * k_dev)
            if k <= 0:
                return torch.zeros((replicas, h, w), dtype=torch.int32, device=dev)
            return hits_on(dev, w, h, k, steps, replicas, scene.seed, burn, lo=d * k_dev)

        img = fern.darken(scene, _sum(mesh, _per_shard(mesh, walker_slice)))
        points = replicas * steps * k_total
    else:
        per_dev = max(1, scene.iterations // n)
        k = int(min(walkers, per_dev))
        steps = max(1, per_dev // k)
        burn = fern._burn_in(scene, scene.width, scene.height)
        curve = fern.scene_curve(scene)

        def replica(d, dev):
            hits = hits_on(dev, scene.width, scene.height, k, steps, 1,
                           scene.seed + d * 7919, burn)[0]
            return fern.apply_darkening(hits, curve).to(torch.int32) if compat_replicas \
                else hits

        total = _sum(mesh, _per_shard(mesh, replica))
        img = (total.clamp_(max=255).to(torch.uint8) if compat_replicas
               else fern.apply_darkening(total, curve))
        points = n * steps * k
    on_kernel = mesh.home.type == "cuda"
    fern.RENDER_STATS.update(tier="fern", route="sharded " + ("kernel H" if on_kernel
                                                              else "plain"),
                             points=points, hist_calls=sum(calls))
    return img


# ---------------------------------------------------------------------------
# Sweeps: frames in contiguous blocks
# ---------------------------------------------------------------------------


def run_frames(mesh: Mesh, n_frames: int, shape, renderer: Callable):
    """Frame-parallel sweeps: shard d renders frames [d·b, (d + 1)·b), b =
    ceil(n_frames / n) (the reference's frame axis padded to a multiple of
    n; the padding frames are not rendered), each into its slot of a slab
    on its device.  ``renderer(lo, hi, device)`` returns ``render(i, out)``,
    which writes frame i into ``out`` and returns a flagged-pixel count
    (a 0-d tensor) or None.  Returns the (n_frames, *shape) uint8 frames on
    the home device and the per-frame counts (None where none)."""
    n, home = mesh.size, mesh.home
    per = -(-n_frames // n)
    out = torch.empty((n_frames,) + tuple(shape), dtype=torch.uint8, device=home)

    def shard(d, dev):
        lo, hi = min(d * per, n_frames), min((d + 1) * per, n_frames)
        slab = (out[lo:hi] if dev == home and not mesh.spans_ranks
                else torch.zeros((per,) + tuple(shape), dtype=torch.uint8, device=dev))
        flags = torch.full((per,), -1, dtype=torch.int64, device=dev)
        if hi > lo:
            render = renderer(lo, hi, dev)
            for i in range(lo, hi):
                f = render(i, slab[i - lo])
                if f is not None:
                    flags[i - lo] = f
        return slab, flags

    parts = _per_shard(mesh, shard)
    if mesh.spans_ranks:
        slabs = _gather(mesh, {d: p[0] for d, p in parts.items()})
        flags = _gather(mesh, {d: p[1] for d, p in parts.items()})
        out = torch.cat(slabs)[:n_frames]
    else:
        flags = [parts[d][1].to(home) for d in range(n)]
        for d, (slab, _) in parts.items():
            lo, hi = min(d * per, n_frames), min((d + 1) * per, n_frames)
            if slab.data_ptr() != out[lo:hi].data_ptr() or slab.device != home:
                out[lo:hi].copy_(slab[:hi - lo])
    counts = [None if c < 0 else c for c in torch.cat(flags)[:n_frames].tolist()]
    return out, counts

