"""The Mandelbrot's work count (``harness`` finds it by the frames' algo):
each frame's pixel-steps, ``portbench.counts.frame_steps``."""

from portbench.counts import frame_steps as frame_work  # noqa: F401
