"""The device mesh and ranks (port of ``fractal_tpu/parallel``)."""
