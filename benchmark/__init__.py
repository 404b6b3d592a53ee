"""The benchmark of mops_tpu_torch: MOPS_* API requests on one card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that decides a result lives here and imports nothing of
the program: the mesh and field generators (meshgen, fields), the traffic
generator (traffic), the float64 reference and its comparison (reference,
check), the step's least bytes (cost) and the trace readers (tracing,
metrics/).  Configurations, traffic mixes, limits and per-layer metrics are
files found by the names in ``BENCHMARK.json``.
"""
