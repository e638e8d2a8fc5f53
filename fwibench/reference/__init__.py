"""The plain reference of the benchmark's comparison: the devito-fwi
objective and first L-BFGS iteration in plain PyTorch and NumPy, written
from the reference's definitions and importing nothing of the program."""
