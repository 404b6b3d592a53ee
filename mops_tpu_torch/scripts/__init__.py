"""Command-line entries of the port: the reference-scale cases
(bench_refscale) and the BASELINE configs (baseline_configs), run as
``python -m mops_tpu_torch.scripts.<name>``."""
