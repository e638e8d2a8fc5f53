"""Nonlinear optimization layer (reference ``optimize/`` + ``minimize.py``)."""
from .optimizers import SteepestDescent, NLCG, LBFGS
from .minimize import minimize
from . import line_search

__all__ = ["SteepestDescent", "NLCG", "LBFGS", "minimize", "line_search"]
