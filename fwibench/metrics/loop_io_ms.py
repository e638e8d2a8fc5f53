"""loop_io_ms: layer driver + optimizer. Per traced iteration, the self
time of the inversion loop's ``loop.dumps`` (model, gradient and residual
dumps, the misfit log, the optimizer's and the line search's metric files)
and ``loop.checkpoint`` spans. Moves iter_s."""
from fwibench.spans import self_ms_per_iteration


def read(rec):
    return self_ms_per_iteration(rec, ("loop.dumps", "loop.checkpoint"))
