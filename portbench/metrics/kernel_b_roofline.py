"""kernel_b_roofline: kernel B's dist-only form (``csrc/perturb.cu``,
``perturb_dist_kernel``) against its least time, in %: the counted frames'
pixel-steps × 18 operations at 3.35e13 operations a second (or the 8 B a
pixel it writes at 3.35 TB/s, whichever is longer), over the kernel's
device time in those frames.  A pixel that does not escape counts the
budget (the p32 tier has no cycle test); no credit for the series skip."""

from portbench.counts import roofline_pct


def read(rec):
    return roofline_pct(rec["frames"], "perturb_dist_kernel", "kernel_b_dist", 8, "to_escape")
