"""The CUDA kernels of devito_fwi_tpu_torch.ops.cuda_acoustic against their
plain torch twins, on the card (marked ``cuda``; each test skips without
one). The file imports no JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up). The kernels
are compiled with -fmad=false and repeat the twins' operations one for one,
so they should agree bitwise: every output within 1e-6 of its max.

Small case: circle-isotropic 61x61, nbl=10, 2 shots, space_order 4 and 8,
with and without the free surface; the residual rows are seeded noise.
"""
import numpy as np
import pytest
import torch

from devito_fwi_tpu_torch import fwi
from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
from devito_fwi_tpu_torch.models.presets import demo_model
from devito_fwi_tpu_torch.ops import cuda_acoustic as ca

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _setup(fs, space_order, dev):
    model = demo_model("circle-isotropic", vp_circle=3.0, vp_background=2.5,
                       origin=(0., 0.), shape=(61, 61), spacing=(10., 10.),
                       nbl=10, space_order=space_order, fs=fs)
    zsrc = 2.0 if fs else 20.0
    src = np.stack([np.linspace(0., 600., 2), np.full(2, zsrc)], 1)
    rec = np.stack([np.linspace(0., 600., 41), np.full(41, 20.)], 1)
    geom = AcquisitionGeometry(model, rec, src, 0., 300., f0=0.010,
                               src_type="Ricker")
    return fwi._Setup(geom, dev)


def _close(got, want):
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= RTOL * float(w.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_forward_kernels_match_twins(cuda, fs, space_order):
    st = _setup(fs, space_order, cuda)
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, 2), st.dt)
    ca.reset_counters()
    rec = ca.forward_rec_segments(*ops, **st.kw)
    got = ca.forward_dt2_segments(*ops, **st.kw)
    assert ca.LAUNCHES["forward_rec_segments"] == 1
    assert ca.LAUNCHES["forward_dt2_segments"] == 1
    assert sum(ca.TWIN_CALLS.values()) == 0
    want = ca.forward_dt2_plain(*ops, **st.kw)
    torch.cuda.synchronize()
    _close([rec], [ca.forward_rec_plain(*ops, **st.kw)])
    _close(got, want)
    assert torch.equal(rec, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("space_order", [4, 8])
@pytest.mark.parametrize("fs", [False, True])
def test_gradient_kernel_matches_twin(cuda, fs, space_order):
    st = _setup(fs, space_order, cuda)
    ops = (st.mT, st.hdT, st.wav_pad, st.injT(0, 2), st.dt)
    dt2 = ca.forward_dt2_plain(*ops, **st.kw)[1]
    rng = np.random.default_rng(0)
    res = torch.as_tensor(rng.standard_normal(
        (2, st.nseg, st.seg, 2, st.nx)), dtype=torch.float32, device=cuda)
    ca.reset_counters()
    got = ca.gradient_stream_segments(st.mT, st.hdT, dt2, res, st.dt,
                                      **st.kw)
    assert ca.LAUNCHES["gradient_stream_segments"] == 1
    want = ca.gradient_stream_plain(st.mT, st.hdT, dt2, res, st.dt, **st.kw)
    torch.cuda.synchronize()
    _close([got], [want])


@pytest.mark.cuda
def test_kernels_reject_float64_on_the_card(cuda):
    st = _setup(False, 4, cuda)
    ops = (st.mT.double(), st.hdT.double(), st.wav_pad.double(),
           st.injT(0, 2).double(), st.dt)
    with pytest.raises(TypeError, match="float64"):
        ca.forward_rec_segments(*ops, **st.kw)
