"""What the solver wrappers share: the wavefield holder and the performance
summary they return.

Port of ``Wavefield`` and ``PerfSummary`` of
``devito_fwi_tpu.ops.wavesolver``. ``AcousticWaveSolver`` of that module is
not ported yet (ROADMAP.md queue A item 3).
"""
from __future__ import annotations

__all__ = ["Wavefield", "PerfSummary"]


class Wavefield:
    """Thin wrapper so callers can use ``.data`` like a devito TimeFunction."""

    def __init__(self, data):
        self.data = data


class PerfSummary:
    """Per-operator performance summary (the reference consumes devito's
    ``summary.gflopss/oi/timings``)."""

    FLOPS_PER_CELL = 40.0   # nominal so=8 stencil+update flop count
    BYTES_PER_CELL = 24.0   # nominal streamed bytes per cell and step

    def __init__(self, elapsed, gpoints):
        self.elapsed = elapsed
        self.gpointss = gpoints / elapsed / 1e9 if elapsed > 0 else 0.0
        self.gflopss = self.gpointss * self.FLOPS_PER_CELL
        self.oi = self.FLOPS_PER_CELL / self.BYTES_PER_CELL
        self.timings = {"kernel": elapsed}

    def __repr__(self):
        return f"PerfSummary(elapsed={self.elapsed:.4f}s, " \
               f"gpoints/s={self.gpointss:.3f}, gflops/s~{self.gflopss:.1f})"
