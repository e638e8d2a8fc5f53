"""The benchmark of devito_fwi_tpu_torch: ``python3 -m fwibench.run``."""
