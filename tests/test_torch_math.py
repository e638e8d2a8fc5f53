"""The port's ``optimize/math.py`` (its own copy of
``devito_fwi_tpu.optimize.math``) against the JAX package's module on
seeded inputs: every function gives the same numbers exactly (both are
numpy and scipy, one for one)."""
import numpy as np
import pytest

from devito_fwi_tpu.optimize import math as jm

from devito_fwi_tpu_torch.optimize import math as tm


def _rng():
    return np.random.default_rng(7)


def _field():
    return _rng().standard_normal((13, 17))


CASES = {
    "gauss2": lambda m: m.gauss2(*np.meshgrid(np.linspace(-2, 2, 9),
                                              np.linspace(-1, 3, 7)),
                                 np.array([0.3, 0.7]),
                                 np.array([[1.2, 0.3], [0.3, 0.8]])),
    "gauss2_unnormalized": lambda m: m.gauss2(
        *np.meshgrid(np.linspace(-2, 2, 9), np.linspace(-1, 3, 7)),
        np.array([0.3, 0.7]), np.array([[1.2, 0.3], [0.3, 0.8]]),
        normalize=False),
    "hilbert": lambda m: m.hilbert(_rng().standard_normal(64)),
    "nextpow2": lambda m: np.array([m.nextpow2(n) for n in (1, 5, 64, 1000)]),
    "normalize": lambda m: m.normalize(_field()),
    "eigsorted": lambda m: np.concatenate(
        [a.ravel() for a in m.eigsorted(_field()[:5] @ _field()[:5].T)]),
    "q_factor": lambda m: np.array(m.q_factor(_field(), _field()[::-1])),
    "nabla": lambda m: m.nabla(_field(), h=[2.0, 3.0]),
    "nabla_unit": lambda m: m.nabla(_field()),
    "nabla2": lambda m: m.nabla2(_field(), h=[2.0, 3.0]),
    "grad": lambda m: np.stack(m.grad(_field(), h=[2.0, 3.0])),
    "tv": lambda m: m.tv(_field(), h=[2.0, 3.0]),
    "dot": lambda m: np.array(m.dot(_field(), _field()[::-1])),
    "angle": lambda m: np.array(m.angle(_field(), _field() + 0.5)),
    "backtrack2": lambda m: np.array([m.backtrack2(1.0, -2.0, 1.0, f1)
                                      for f1 in (0.5, 1.5, 3.0, 30.0)]),
    "polyfit2": lambda m: np.array(m.polyfit2(np.array([0.0, 1.0, 2.0]),
                                              np.array([3.0, 1.0, 2.0]))),
    "infinity": lambda m: np.array(m.infinity),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax_package_exactly(name):
    got, want = CASES[name](tm), CASES[name](jm)
    np.testing.assert_array_equal(got, want)


def test_math_exports_the_same_names():
    assert tm.__all__ == jm.__all__
    assert tm.__file__ != jm.__file__
