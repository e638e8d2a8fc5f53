"""trials_per_iter: layer optimizer. Misfit-only line-search calls of the
window per iteration completed. Moves iter_s."""


def read(rec):
    if not rec["iterations"]:
        return None
    return sum(1 for c in rec["calls"] if not c["grad"]) / rec["iterations"]
