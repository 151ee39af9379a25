"""The paper's experiments on the port (counterparts of the reference's
``benchmarks/``): the five-method comparison, Experiments I–III, the
communication count, the non-IID ablation and the kernel micro-benchmarks.
Each module runs as ``python -m repro_torch.benchmarks.<name>`` and writes
under ``results_torch/`` by default."""
