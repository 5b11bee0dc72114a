"""The benchmark of gnnflow_tpu_torch: ``python -m portbench``."""
