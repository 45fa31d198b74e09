"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  See ``portbench/README.md`` for how cells, configurations,
traffic mixes and per-layer metrics are added as files.
"""
