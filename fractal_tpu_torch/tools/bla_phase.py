"""Where a phase of the fe BLA kernel goes, at bla1e40 on one CUDA card.

    python -m fractal_tpu_torch.tools.bla_phase

Builds variants of ``csrc/perturb_bla_fe.cu`` from the checkout's source
under ``build/fractal_tpu_torch/bla_phase`` (nothing of them is kept in the
repository): the register form at 5 and at 8 pixels a thread (8: one block
an SM), the general floatexp ops only (the closed-domain path switched off)
and a barrier a gate group in place of the grid-wide one; and a skeleton of
the kernel's phase without pixel work (the slot reads, the stale slot's
reset, one block reduction and its atomics, then the barrier), grid-wide and
a group.  Times each variant in both state forms by CUDA events and the
profiler, interleaved with the committed kernel, each output held bit-equal
to the committed kernel's; and the skeleton at 30 and 300 phases, whose
difference over 270 is a phase's barrier and bookkeeping alone.  The
streaming form less the register form is a phase's pass of the state
through memory.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

SKELETON = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
namespace {
constexpr int THREADS = 256;
__device__ void group_sync(unsigned* count, volatile unsigned* gen, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(count, 1u) == nblocks - 1) {
      *count = 0;
      __threadfence();
      atomicAdd(const_cast<unsigned*>(gen), 1u);
    } else {
      while (*gen == g0) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}
template <bool GROUP>
__global__ void __launch_bounds__(THREADS) skeleton(int phases, int groups, int bpg,
                                                   unsigned long long* keys, int* cont,
                                                   unsigned* bar) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long red[THREADS / 32];
  __shared__ int dec;
  const int g = blockIdx.x / bpg;
  for (int phase = 1; phase <= phases; ++phase) {
    const int slot = phase % 3, next = (phase + 1) % 3, stale = (phase + 2) % 3;
    if (threadIdx.x == 0)
      dec = *reinterpret_cast<volatile int*>(&cont[slot * groups + g]) +
            static_cast<int>(*reinterpret_cast<volatile unsigned long long*>(
                                 &keys[slot * groups + g]) & 1);
    if (GROUP ? blockIdx.x % bpg == 0 : blockIdx.x == 0)
      for (int i = GROUP ? g : threadIdx.x; i < (GROUP ? g + 1 : groups); i += THREADS) {
        keys[stale * groups + i] = 0;
        cont[stale * groups + i] = 0;
      }
    __syncthreads();
    unsigned long long v = (static_cast<unsigned long long>(threadIdx.x) << 20) ^ (phase + dec);
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < THREADS / 32; ++w) v = max(v, red[w]);
      atomicMax(&keys[next * groups + g], v);
      atomicOr(&cont[next * groups + g], 1);
    }
    if (GROUP)
      group_sync(bar + 2 * g, bar + 2 * g + 1, bpg);
    else
      grid.sync();
  }
}
}  // namespace
extern "C" int skeleton_run(int group, int phases, int groups, int bpg, unsigned long long* keys,
                            int* cont, unsigned* bar, void* stream) {
  void* fn = group ? reinterpret_cast<void*>(skeleton<true>) : reinterpret_cast<void*>(skeleton<false>);
  void* args[] = {&phases, &groups, &bpg, &keys, &cont, &bar};
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(groups * bpg), dim3(THREADS), args, 0,
                                              static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}
"""

GROUP_SYNC = SKELETON[SKELETON.index("__device__ void group_sync"):
                      SKELETON.index("template <bool GROUP>")]

# (name, [(text of the committed source, its replacement)]); every text must
# be found, so a changed kernel fails here instead of timing something else
VARIANTS = [
    ("k5", [("constexpr int REG_K = 4;", "constexpr int REG_K = 5;")]),
    ("k8", [("constexpr int REG_K = 4;", "constexpr int REG_K = 8;"),
            ("constexpr int REG_MIN_BLOCKS = 2;", "constexpr int REG_MIN_BLOCKS = 1;")]),
    ("general ops", [("return fe_step_ready(px.dzr) && fe_step_ready(px.dzi);",
                      "return false && fe_step_ready(px.dzr);")]),
    ("group barrier", [
        ("  int* cont;                  // SLOTS\n", "  int* cont;\n  unsigned* bar;\n"),
        ("  a.cont = cont;\n", "  a.cont = cont;\n  a.bar = reinterpret_cast<unsigned*>(cont + 3 * groups);\n"),
        ("atomicOr(&a.cont[slot], 1);", "atomicOr(&a.cont[slot * a.groups + g], 1);"),
        ("&a.cont[slot]);", "&a.cont[slot * a.groups + g]);"),
        ("    if (blockIdx.x == 0) {  // nobody reads or writes the stale slot in this phase\n"
         "      for (int i = threadIdx.x; i < a.groups; i += THREADS) {\n",
         "    if (blockIdx.x % a.blocks_per_group == 0) {\n"
         "      for (int i = g + threadIdx.x; i < g + 1; i += THREADS) {\n"),
        ("      if (threadIdx.x == 0) a.cont[stale] = 0;\n",
         "      if (threadIdx.x == 0) a.cont[stale * a.groups + g] = 0;\n"),
        ("grid.sync();", "group_sync(a.bar + 2 * g, a.bar + 2 * g + 1, a.blocks_per_group);"),
        ("// K > 0: the register form", GROUP_SYNC + "// K > 0: the register form")]),
]


def _variant_source(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the kernel's source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch

    from fractal_tpu_torch.config import Scene
    from fractal_tpu_torch.utils.timing import profile_warm
    from fractal_tpu_torch.ops import _cuda_build, perturb, perturb_cuda
    from fractal_tpu_torch.utils.timing import card_line, event_ms

    if not torch.cuda.is_available():
        raise SystemExit("bla_phase needs a CUDA card")
    print(card_line(), flush=True)
    main_lib = _cuda_build.load()
    out = os.path.join(_cuda_build.BUILD_DIR, "bla_phase")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_cuda_build.CSRC, "perturb_bla_fe.cu")) as f:
        src = f.read()
    nvcc = _cuda_build._nvcc()
    jobs = []
    for name, pairs in VARIANTS + [("skeleton", None)]:
        cu = os.path.join(out, name.replace(" ", "_") + ".cu")
        with open(cu, "w") as f:
            f.write(SKELETON if pairs is None else _variant_source(src, pairs))
        so = cu[:-3] + ".so"
        cmd = [nvcc, *_cuda_build.NVCC_FLAGS, "-I", _cuda_build.CSRC, "-shared", cu, "-o", so]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {"committed": main_lib}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        for kname, regs, spill in _cuda_build.kernel_resources(log):
            print(f"ptxas {name}: {kname}: {regs} registers, {spill} bytes of spill stores",
                  flush=True)
        lib = ctypes.CDLL(so)
        if name == "skeleton":
            lib.skeleton_run.argtypes = [i] * 4 + [p] * 4
            lib.skeleton_run.restype = i
        else:
            perturb_cuda.bind_bla_fe(lib)
        libs[name] = lib

    sc = Scene(width=512, height=384, iterations=4000, scale=(1e40, 1e40), inside=False,
               pos_str=MINIBROT_1E40)
    st = perturb.perturb_setup(sc, "cuda")
    pk = perturb._packed_tensor(st.orbit, "cuda")
    bla = perturb._bla_tensor(st.bla, "cuda")
    groups, band = 2, perturb.PERT_BAND_ROWS
    offsets = (ctypes.c_int * len(bla.offsets))(*bla.offsets)

    def launch(lib, form):
        shape = (groups * band, sc.width)
        zr, zi = torch.empty(shape, device="cuda"), torch.empty(shape, device="cuda")
        cnt = torch.empty(shape, dtype=torch.int32, device="cuda")
        gl = torch.empty_like(cnt)
        dz = torch.empty((4, zr.numel()), dtype=torch.int32, device="cuda")
        # keys, live votes, and room for a group's go-on votes and barrier
        slots = torch.zeros(14 * groups + 3, dtype=torch.int32, device="cuda")
        base = slots.data_ptr()
        err = lib.fractal_perturb_bla_fe(
            st.P.data_ptr(), pk.data_ptr(), pk.shape[0], st.n_steps, sc.iterations,
            bla.packed.data_ptr(), bla.packed.shape[0], offsets, len(bla.offsets),
            perturb_cuda.BLA_MIN_LEVEL, 1, form, groups, band, sc.width, zr.data_ptr(),
            zi.data_ptr(), cnt.data_ptr(), gl.data_ptr(), dz.data_ptr(), base,
            base + 24 * groups, base + 36 * groups, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {_cuda_build.error_string(err)}")
        return zr, zi, cnt, gl

    def device_ms(fn, reps: int = 5):
        """The profiler's mean device time of the fe BLA kernel a call."""
        _, _, top = profile_warm(lambda: [fn() for _ in range(reps)], top=8)
        hits = [t / calls for kname, t, calls in top if "perturb_bla_fe_kernel" in kname]
        return hits[0] if hits else None

    want = launch(main_lib, 1)
    names = ["committed"] + [name for name, _ in VARIANTS]
    for rnd in range(2):  # the committed kernel first and again after the variants
        for name in names + (["committed"] if rnd else []):
            for form, label in ((1, "registers"), (0, "streaming")):
                got = launch(libs[name], form)
                equal = all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                        b.view(torch.int32) if b.is_floating_point() else b)
                            for a, b in zip(got, want))
                if not equal:
                    raise RuntimeError(f"{name} ({label}) differs from the committed kernel")
                ms, _ = event_ms(lambda: launch(libs[name], form), reps=20)
                print(f"round {rnd} {name} ({label}), bla1e40: {ms!r} ms by events, "
                      f"{device_ms(lambda: launch(libs[name], form))!r} ms on the device; "
                      f"bit-equal to the committed kernel", flush=True)
    lib = libs["skeleton"]
    for group, label in ((0, "grid-wide"), (1, "a group's")):
        for g, bpg in ((2, 128), (2, 64), (1, 128), (2, 32)):
            def run(phases):
                keys = torch.zeros(3 * g, dtype=torch.int64, device="cuda")
                cont = torch.zeros(5 * g, dtype=torch.int32, device="cuda")
                err = lib.skeleton_run(group, phases, g, bpg, keys.data_ptr(), cont.data_ptr(),
                                       cont.data_ptr() + 12 * g,
                                       torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"skeleton launch failed: {err}")

            t30 = event_ms(lambda: run(30), reps=20)[0]
            t300 = event_ms(lambda: run(300), reps=20)[0]
            print(f"skeleton, {label} barrier, {g} groups x {bpg} blocks of 256: 30 phases "
                  f"{t30!r} ms, 300 phases {t300!r} ms: {(t300 - t30) / 270 * 1e3!r} us a "
                  f"phase", flush=True)
    return 0


# bla1e40's centre (bench.py:238-239, as chip_smoke.py's MINIBROT_1E40)
MINIBROT_1E40 = (
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

if __name__ == "__main__":
    raise SystemExit(main())
