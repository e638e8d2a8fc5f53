"""SMARMN Marmousi acoustic FWI driver (reference ``marmousi_fwi.py``):

    python -m devito_fwi_tpu_torch.drivers.marmousi_fwi --misfit 0 --maxiter 2

See ``_marmousi_common.py`` for the configuration and flow."""
from ._marmousi_common import SMARMN, run_fwi

if __name__ == "__main__":
    run_fwi(SMARMN)
