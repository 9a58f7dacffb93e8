"""coloring_ms: device milliseconds a frame of the p32 tier spends in
torch's coloring (``ops/perturb.py``'s ``coloring`` span around
``render._color_and_downsample_dist``).  The reader cannot see which span
launched an operation, so it takes the rule of one stream: the operations
that start after kernel B's dist kernel (``perturb_dist_kernel``) has
ended and before the frame's copy to the host (``Memcpy DtoH``) starts,
their device times summed.  Averaged over the frames that have a
``coloring`` span, kernel B's kernel and the copy; None where none has."""

KERNEL = "perturb_dist_kernel"
COPY = "Memcpy DtoH"


def read(rec):
    times = []
    for f in rec["frames"]:
        if not any(kind == "coloring" for kind, _, _, _ in f["split"]):
            continue
        ops = f.get("kernels", ())
        ends = [e for name, _, e in ops if KERNEL in name]
        if not ends:
            continue
        after = max(ends)
        copies = [s for name, s, _ in ops if name.startswith(COPY) and s >= after]
        if not copies:
            continue
        before = min(copies)
        times.append(sum(e - s for _, s, e in ops if after <= s < before) * 1e3)
    return sum(times) / len(times) if times else None
