"""The first W2-2d objective of the SMARMN inversion (the driver's starting
model ``vp.smooth_20``, 29 shots, nt 1357, the direct wave subtracted, the
JAX driver's qWasserstein: gamma 1.01, 15 BFM steps) in float64 on the
CPU, through the JAX package and through the port: the two agree, and
their value is the one ``chip_smoke.py`` phase 7 holds the port's float32
run on the card to (``W2_FIRST_F64``). The JAX system's run on the TPU
(``result_r5/w2_50``) logged 4.226e-06, which lies 6.1e-3 below it, and
the JAX package's own float32 objective on the CPU lies further still.

Marked slow: at SMARMN's full size on the CPU (a few GB) the JAX
package's float64 objective takes about 25 minutes and its float32 one
17, the port's float64 one about 45 on 6 threads.
"""
import os
import sys

import numpy as np
import pytest
import torch

from devito_fwi_tpu import AcquisitionGeometry as JGeometry
from devito_fwi_tpu import SeismicModel as JModel
from devito_fwi_tpu import fwi as jfwi
from devito_fwi_tpu.misfit import qWasserstein as JQ

from devito_fwi_tpu_torch import AcquisitionGeometry, SeismicModel
from devito_fwi_tpu_torch import fwi as tfwi
from devito_fwi_tpu_torch.misfit import qWasserstein

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, NSRC = (300, 106), 29


def _geometries(model_cls, geometry_cls, dtype):
    """(true, initial, water) geometries of the SMARMN driver."""
    base = os.path.join(REPO, "model_data", "SMARMN")
    vps = [np.fromfile(os.path.join(base, n), np.float32).reshape(SHAPE)
           / 1000 for n in ("vp.true", "vp.smooth_20")]
    vps.append(np.ones(SHAPE) * 1.5)
    models = [model_cls(origin=(0, 0), spacing=(30., 30.), shape=SHAPE,
                        space_order=8, vp=v, nbl=40, fs=False, dt=2.95,
                        bcs="damp", dtype=dtype) for v in vps]
    width = models[0].domain_size[0]
    src = np.stack([np.linspace(0, width, NSRC), np.full(NSRC, 60.)], 1)
    rec = np.stack([np.linspace(30., width - 30., 300), np.full(300, 60.)],
                   1)
    return [geometry_cls(m, rec, src, 0., 4000., f0=0.007,
                         src_type="Ricker") for m in models]


def _mask():
    mask = np.ones(SHAPE, np.float32)
    mask[:, :7] = 0
    return mask


def _jax_objective(dtype):
    g1, g0, g2 = _geometries(JModel, JGeometry, dtype)
    f, _, _ = jfwi.fwi_obj_multi(
        g0, jfwi.fm_multi(g1), JQ(gamma=1.01, method="2d", num_steps=15,
                                  step_scale=1.), jfwi.fm_multi(g2), _mask(),
        True, calc_grad=False)
    return f


@pytest.fixture(scope="module")
def jax_f64():
    return _jax_objective(np.float64)


@pytest.mark.slow
def test_first_w2_objective_at_float64(jax_f64):
    sys.path.insert(0, REPO)
    import chip_smoke
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        p1, p0, p2 = _geometries(SeismicModel, AcquisitionGeometry,
                                 np.float64)
        f_port, _, _ = tfwi.fwi_obj_multi(
            p0, tfwi.fm_multi(p1, device="cpu"),
            qWasserstein(gamma=1.01, method="2d", num_steps=15,
                         step_scale=1.), tfwi.fm_multi(p2, device="cpu"),
            _mask(), True, calc_grad=False, device="cpu")
    finally:
        torch.set_num_threads(saved)
    assert abs(f_port - jax_f64) <= 1e-6 * jax_f64, (f_port, jax_f64)
    assert abs(jax_f64 - chip_smoke.W2_FIRST_F64) <= 1e-6 * jax_f64, jax_f64
    # the TPU run's first logged line
    first = open(os.path.join(REPO, "result_r5", "w2_50", "log2",
                              "misfit")).readline().split()
    assert abs(float(first[0]) - jax_f64) > 5e-3 * jax_f64


@pytest.mark.slow
def test_jax_float32_objective_parts_from_float64(jax_f64):
    """The JAX package's own float32 objective on the CPU lies further from
    its float64 one than the TPU run's first line: the W2-2d objective is
    ill-conditioned in float32 at SMARMN, in either package."""
    f32 = _jax_objective(np.float32)
    tpu = float(open(os.path.join(REPO, "result_r5", "w2_50", "log2",
                                  "misfit")).readline().split()[0])
    assert abs(f32 - jax_f64) > abs(tpu - jax_f64), (f32, tpu, jax_f64)
