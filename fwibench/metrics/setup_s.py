"""setup_s: from the process's start to the window's: imports, the kernels
loaded (and built in a fresh checkout), models and geometry, the observed
and direct-wave data modeled, one gradient and one trial warmed up."""


def read(rec):
    return rec["setup_s"]
