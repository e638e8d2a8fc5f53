"""The plain reference of the benchmark's comparison: the devito-fwi
objective and first L-BFGS iteration in plain PyTorch and NumPy, written
from the reference's definitions and importing nothing of the program.

A configuration's family is an objective of its own,
``families/<family>.py``, and a workload's misfit a function of its own,
``misfits/<name>.py`` by the drivers' ``--misfit`` numbering;
``objective.build`` loads both from their files, so that a new family or
misfit is added as a file (``objective.py`` gives their contracts)."""
