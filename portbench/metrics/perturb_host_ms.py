"""perturb_host_ms: milliseconds a frame that the host spends on the
perturbation path's own work: the program's spans ``walk``, ``probe``, ``P
block``, ``BLA table`` and ``direct`` (``ops/perturb.SPLIT``), summed in
each frame and averaged over the frames; None where no frame took that
path."""

HOST_STEPS = ("walk", "probe", "P block", "BLA table", "direct")


def read(rec):
    frames = [f for f in rec["frames"] if f["split"]]
    if not frames:
        return None
    return sum(ms for f in frames for kind, _, ms, _ in f["split"]
               if kind in HOST_STEPS) / len(frames)
