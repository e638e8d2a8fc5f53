"""Time axis bookkeeping.

API-parity re-implementation of the reference ``TimeAxis``
(``seismic/source.py:15-75``): exactly three of start/step/num/stop must be
given; ``num`` is derived with a ceil so the realised ``stop`` may differ from
the requested one.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TimeAxis"]


class TimeAxis:
    def __init__(self, start=None, step=None, num=None, stop=None):
        try:
            if start is None:
                start = step * (1 - num) + stop
            elif step is None:
                step = (stop - start) / (num - 1)
            elif num is None:
                num = int(np.ceil((stop - start + step) / step))
                stop = step * (num - 1) + start
            elif stop is None:
                stop = step * (num - 1) + start
            else:
                raise ValueError("Only three of start, step, num and stop may be set")
        except Exception:
            raise ValueError("Three of args start, step, num and stop may be set")

        if not isinstance(num, int):
            raise TypeError("input argument must be of type int")

        self.start = start
        self.stop = stop
        self.step = step
        self.num = num

    def __str__(self):
        return ("TimeAxis: start=%g, stop=%g, step=%g, num=%g"
                % (self.start, self.stop, self.step, self.num))

    def __eq__(self, other):
        return (isinstance(other, TimeAxis) and self.start == other.start and
                self.stop == other.stop and self.step == other.step and
                self.num == other.num)

    def _rebuild(self):
        return TimeAxis(start=self.start, stop=self.stop, num=self.num)

    @property
    def time_values(self):
        return np.linspace(self.start, self.stop, self.num)
