"""push_slab_pct: layer misfit. 100 x the W2-2d pushforwards that took the
slab kernel over all pushforwards of the run up to the window's end
(the program's ``misfit.bfm.COUNTS``). The roofline w2_push_roofline is
right only where this reads 100. Moves trial_ms."""
import importlib


def read(rec):
    # the module: the package exports a class of the same name
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    counts = getattr(bfm, "COUNTS", {})
    tiers = [counts.get(k, 0) for k in ("push_slab", "push_banded",
                                        "push_scatter")]
    return 100.0 * tiers[0] / sum(tiers) if sum(tiers) else None
