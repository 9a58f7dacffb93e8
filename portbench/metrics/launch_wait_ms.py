"""launch_wait_ms: milliseconds from a frame's call to the end of its main
launch's span, ``kernel A`` (``render._render_params``) or ``kernel B dist``
(``ops/perturb.render_perturb_band``): the render driver's and the host
set-up's work before the card gets the frame's main kernel, averaged over
the frames that have such a span; None where none has."""

MAIN_LAUNCHES = ("kernel A", "kernel B dist")


def read(rec):
    waits = []
    for f in rec["frames"]:
        ends = [end for kind, _, _, end in f["split"] if kind in MAIN_LAUNCHES]
        if ends:
            waits.append((ends[0] - f["t0"]) * 1e3)
    return sum(waits) / len(waits) if waits else None
