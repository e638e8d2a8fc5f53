"""SMARM2 Marmousi forward-modeling driver (reference ``marmousi2_fm.py``):

    python -m devito_fwi_tpu_torch.drivers.marmousi2_fm [--device cpu]

writes the observed, smooth-model and direct-wave gathers of 21 shots under
``--odir``. See ``_marmousi_common.py`` for the configuration and flow."""
from ._marmousi_common import SMARM2, run_fm

if __name__ == "__main__":
    run_fm(SMARM2)
