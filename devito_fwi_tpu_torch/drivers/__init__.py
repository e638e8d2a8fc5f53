"""Command-line drivers of the port (``python -m
devito_fwi_tpu_torch.drivers.marmousi_fwi``)."""
