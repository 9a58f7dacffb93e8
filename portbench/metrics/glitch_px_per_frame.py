"""glitch_px_per_frame: the pixels a frame of the exact perturbation tier
flags as glitched and resolves (``ops/perturb.RENDER_STATS["n_glitch"]``),
averaged over the frames; None where no frame took that tier."""


def read(rec):
    n = [f["stats"]["n_glitch"] for f in rec["frames"]
         if f["stats"].get("tier") in ("perturb", "floatexp")
         and f["stats"].get("n_glitch") is not None]
    return sum(n) / len(n) if n else None
