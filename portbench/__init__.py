"""The benchmark of the PyTorch and CUDA port (``fractal_tpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of the repository.  The cells
are ``BENCHMARK.json``'s workloads."""
