"""SMARM2 Marmousi FWI driver (reference ``marmousi2_fwi.py``), acoustic or
elastic:

    python -m devito_fwi_tpu_torch.drivers.marmousi2_fwi --physics elastic --misfit 0 --maxiter 2

See ``_marmousi_common.py`` for the configuration and flow."""
from ._marmousi_common import SMARM2, run_fwi

if __name__ == "__main__":
    run_fwi(SMARM2)
