"""The benchmark of mcrat_tpu_torch, the PyTorch and CUDA port of MCRaT.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one NVIDIA GPU.
Configurations (``configs/``), traffic mixes (``traffic/``) and metrics
(``metrics/``) are files found by the names in ``BENCHMARK.json``; the plain
reference that decides ``correct`` is ``reference/``.  Nothing here imports
JAX or the JAX package.
"""
