"""lbfgs_ms: layer optimizer. Per traced iteration, the self time of the
inversion loop's ``loop.direction`` (the L-BFGS two-loop recursion) and
``loop.search`` spans (the line search's logic and the bounded models; its
metric files and its trials are not in it). Moves iter_s."""
from fwibench.spans import self_ms_per_iteration


def read(rec):
    return self_ms_per_iteration(rec, ("loop.direction", "loop.search"))
