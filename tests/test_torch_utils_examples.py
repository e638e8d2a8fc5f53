"""The port's utilities (``utils/nmo.py``, ``utils/plotting.py``,
``utils/profiling.py``) and its three tutorial examples
(``examples/staggered_acoustic.py``, ``time_update.py``,
``time_blocking.py``) on the CPU:

* ``nmo_correction`` equal to the JAX package's on a random gather;
* the four plotting functions draw on matplotlib's Agg canvas from numpy
  arrays and from tensors;
* ``profiling.trace`` writes a Chrome trace naming the profiled calls, and
  ``timed`` reports a line through its sink;
* each example's goldens, through its ``main``: norm(p) 0.35098 / 0.33737
  (atol 1e-4), the three time-update checks, and the time-blocking
  gradients within 1e-5 (checkpoints, the streamed float32 history through
  the kernels' twins) and 1% (the bfloat16 history) of the all-saved one,
  each check against the JAX example's own numbers.
"""
import json
import os

import numpy as np
import pytest
import torch

from devito_fwi_tpu.utils.nmo import nmo_correction as j_nmo

from devito_fwi_tpu_torch.examples import (staggered_acoustic, time_blocking,
                                           time_update)
from devito_fwi_tpu_torch.models.geometry import setup_geometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.utils import plotting, profiling
from devito_fwi_tpu_torch.utils.nmo import nmo_correction


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nmo_equals_jax(dtype):
    rng = np.random.default_rng(7)
    gather = rng.standard_normal((300, 24)).astype(dtype)
    offsets = np.linspace(0., 2300., 24)
    vel = np.linspace(1500., 3200., 300)
    got = nmo_correction(gather, 0.004, offsets, vel)
    want = j_nmo(gather, 0.004, offsets, vel)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plotting_draws_arrays_and_tensors(as_tensor):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    model = demo_model("circle-isotropic", shape=(21, 21),
                       spacing=(10., 10.), nbl=4, space_order=4)
    model1 = demo_model("circle-isotropic", shape=(21, 21),
                        spacing=(10., 10.), nbl=4, space_order=4,
                        vp_circle=3.3)
    geometry = setup_geometry(model, 100.)
    conv = torch.as_tensor if as_tensor else np.asarray
    rec = conv(np.random.default_rng(0).standard_normal((101, 21)))
    image = conv(np.random.default_rng(1).random((21, 21)))
    plotting.plot_velocity(model, source=conv(geometry.src_positions),
                           receiver=conv(geometry.rec_positions),
                           show=False)
    plotting.plot_perturbation(model, model1, show=False)
    plotting.plot_shotrecord(rec, model, 0., 100., show=False)
    plotting.plot_image(image, show=False)
    assert len(plt.gcf().axes) >= 1
    plt.close("all")


def test_profiling_trace_and_timed(tmp_path):
    logdir = str(tmp_path / "tr")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as prof:
        torch.matmul(x, x)
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert any(ev.get("name") == "aten::matmul"
               for ev in trace["traceEvents"])
    lines = []
    with profiling.timed("matmul", sink=lines.append):
        torch.matmul(x, x)
    assert len(lines) == 1 and lines[0].startswith("matmul: ")
    assert float(lines[0].split()[1]) >= 0.0


def test_staggered_acoustic_goldens():
    norms = staggered_acoustic.main(["--device", "cpu"])
    for so, want in staggered_acoustic.GOLDEN.items():
        assert abs(norms[so] - want) <= 1e-4


def test_time_update_checks():
    d1, d2, orders = time_update.main(["--device", "cpu"])
    assert d1 < 1e-6 and d2 < 1e-5 and all(o > 1.8 for o in orders)


def test_time_blocking_checks():
    diffs = time_blocking.main(["--device", "cpu"])
    assert set(diffs) == set(time_blocking.LIMITS)
    for name, d in diffs.items():
        assert d < time_blocking.LIMITS[name], name
