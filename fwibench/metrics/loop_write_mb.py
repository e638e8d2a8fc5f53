"""loop_write_mb: layer driver + optimizer. Megabytes the inversion loop
wrote in the window (dumps, metric files, checkpoints: the program's
``optimize.tools.COUNTS``, read after the window) per iteration completed.
Moves iter_s."""


def read(rec):
    from devito_fwi_tpu_torch.optimize import tools
    counts = getattr(tools, "COUNTS", None)
    if counts is None or not rec["iterations"]:
        return None
    return counts["bytes_written"] / 1e6 / rec["iterations"]
