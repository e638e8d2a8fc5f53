"""legendre_fallback_pct: layer misfit. 100 x the one-axis Legendre
transforms whose anchored evaluation failed its certificate and ran the
full transform over those the anchored route attempted (each reads its
certificate once), in the run up to the window's end (the program's
``misfit.bfm.COUNTS``). Moves trial_ms."""
import importlib


def read(rec):
    # the module: the package exports a class of the same name
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    counts = getattr(bfm, "COUNTS", {})
    tried = counts.get("legendre_reads", 0)
    return 100.0 * counts.get("legendre_fallbacks", 0) / tried if tried \
        else None
