"""Example flows of the port (``python -m
devito_fwi_tpu_torch.examples.inversion_fwi``)."""
