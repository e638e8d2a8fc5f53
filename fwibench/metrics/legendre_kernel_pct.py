"""legendre_kernel_pct: layer misfit. 100 x the one-axis anchored Legendre
transforms that ran on the hand-written kernel (``legendre_kernel``) over
those whose certificate was read (``legendre_reads``), in the run up to the
window's end (the program's ``misfit.bfm.COUNTS``). A program without the
kernel's counter reads nothing. Moves trial_ms."""
import importlib


def read(rec):
    # the module: the package exports a class of the same name
    bfm = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
    counts = getattr(bfm, "COUNTS", {})
    reads = counts.get("legendre_reads", 0)
    if "legendre_kernel" not in counts or not reads:
        return None
    return 100.0 * counts["legendre_kernel"] / reads
