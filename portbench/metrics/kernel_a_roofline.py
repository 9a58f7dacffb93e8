"""kernel_a_roofline: kernel A's colored ds32 form (``csrc/escape.cu``,
``escape_kernel``) against its least time, in %: the counted frames'
pixel-steps × 80 operations at 3.35e13 operations a second (or their 3 B a
pixel at 3.35 TB/s, whichever is longer), over the kernel's device time in
those frames.  A pixel that does not escape counts the steps until the
route's cycle test stops it, or the budget (``portbench.counts``)."""

from portbench.counts import roofline_pct


def read(rec):
    return roofline_pct(rec["frames"], "escape_kernel", "kernel_a_ds32", 3, "with_cycle")
