"""Small IO helpers (reference ``optimize/tools.py``, with its missing
``os`` import fixed), and the count of what the inversion loop writes:
every dump, metric log and checkpoint of ``minimize`` adds its bytes and,
for a file it creates, one file to ``COUNTS``."""
from __future__ import annotations

import os

import numpy as np

from ..utils.profiling import span

__all__ = ["Writer", "loadnpy", "savenpy", "exists", "COUNTS",
           "reset_counters", "append_text", "write_array", "count_file"]

# bytes the inversion loop wrote and files it created
COUNTS = {"bytes_written": 0, "files_written": 0}


def reset_counters():
    for key in COUNTS:
        COUNTS[key] = 0


def count_file(nbytes, created):
    """Add a write of ``nbytes`` to ``COUNTS`` (and a file, if it created
    one)."""
    COUNTS["bytes_written"] += int(nbytes)
    COUNTS["files_written"] += bool(created)


def append_text(path, text):
    """Append ``text`` (ASCII) to the file at ``path``, counted."""
    with span("loop.dumps"):
        created = not os.path.exists(path)
        with open(path, "a") as f:
            f.write(text)
        count_file(len(text), created)


def write_array(a, path):
    """``a.tofile(path)``, counted."""
    with span("loop.dumps"):
        created = not os.path.exists(path)
        a.tofile(path)
        count_file(a.nbytes, created)


class Writer:
    """Append-only scalar metric files (same as optimizers.Writer)."""

    def __init__(self, path="."):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def __call__(self, filename, val):
        with open(os.path.join(self.path, filename), "a") as f:
            f.write("%e\n" % val)


def loadnpy(filename):
    return np.load(filename)


def savenpy(filename, v):
    np.save(filename, v)
    os.rename(filename + ".npy", filename)


def exists(names):
    """True if all given paths exist."""
    if isinstance(names, str):
        names = [names]
    return all(name and os.path.exists(name) for name in names)
