"""The plain reference against the port's objective on the CPU at
float64 (the port's plain twins), at 41 x 41 with three jittered shots:
the L2 acoustic and L2 elastic objective and gradient at the starting
model, as the optimizer gets them (illumination fix, precondition and
mask applied). The W2-2d reference is not written yet (PERF.md, Open
questions). The reference found by file (its family's objective and the
workload's misfit) reads bit for bit what it read when both were fixed
in ``objective.py``."""
import hashlib

import numpy as np
import pytest
import torch

from fwibench import lib
from fwibench.reference import objective
from fwibench.tests import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make(str(tmp_path_factory.mktemp("fwibench")))


def _port_models(cfg, data_dir, dt, elastic):
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.models.model import SeismicModel
    true, smooth = objective.load_models(cfg, data_dir)
    kw = dict(origin=(0, 0), spacing=tuple(cfg["spacing"]),
              shape=tuple(cfg["shape"]), space_order=cfg["space_order"],
              nbl=cfg["nbl"], fs=False, dt=dt, dtype=np.float64)
    water = np.full(cfg["shape"], cfg["water_vp"])
    if not elastic:
        return [SeismicModel(vp=v, bcs="damp", **kw)
                for v in (true, smooth, water)], smooth, None
    mcfg = marm.MarmousiConfig(name="TINY", shape=tuple(cfg["shape"]), dt=0.,
                               tn=cfg["tn"], nsrc_default=3,
                               bathy_rows=cfg["water_rows"],
                               w2_step_scale=1.)
    models = []
    for vp in (true, smooth):
        vs, rho = marm.elastic_fields(mcfg, vp)
        models.append(SeismicModel(vp=vp.astype(np.float64),
                                   vs=vs.astype(np.float64),
                                   b=1 / rho.astype(np.float64),
                                   bcs="mask", **kw))
    models.append(SeismicModel(vp=water, vs=np.zeros(cfg["shape"]),
                               b=np.ones(cfg["shape"]), bcs="mask", **kw))
    return models, smooth, marm.elastic_fields(mcfg, smooth)


@pytest.mark.parametrize("cell", ["tiny-acoustic", "tiny-elastic"])
def test_reference_matches_the_port_in_float64(tree, cell):
    from devito_fwi_tpu_torch import elastic_fwi, fwi
    from devito_fwi_tpu_torch.misfit import least_square
    from devito_fwi_tpu_torch.models.geometry import AcquisitionGeometry
    root, here, data_dir = tree
    bench = lib.Bench(root, here=here)
    work = bench.workload(cell)
    cfg = bench.config(cell)
    src, rec = lib.acquisition(cfg, work, 20240611)
    ref = objective.build(cfg, work, src, rec, data_dir, "cpu",
                          dtype=torch.float64, here=here)
    elastic = cfg["family"] == "elastic"
    models, smooth, pinned = _port_models(cfg, data_dir, ref.dt, elastic)
    geoms = [AcquisitionGeometry(m, rec, src, 0., cfg["tn"], f0=cfg["f0"],
                                 src_type="Ricker") for m in models]
    mask = np.ones(cfg["shape"])
    mask[:, :cfg["water_rows"]] = 0
    m0 = 1.0 / smooth.reshape(-1).astype(np.float64) ** 2
    if elastic:
        obs = elastic_fwi.elastic_fm_multi(geoms[0], device="cpu")[0]
        dw = elastic_fwi.elastic_fm_multi(geoms[2], device="cpu")[0]
        loss = elastic_fwi.ElasticFwiLoss(*pinned, device="cpu")
    else:
        obs = fwi.fm_multi(geoms[0], device="cpu")
        dw = fwi.fm_multi(geoms[2], device="cpu")

        def loss(*a, **k):
            return fwi.fwi_loss(*a, device="cpu", **k)
    f, g, _ = loss(m0, geoms[1], obs, least_square, dw, mask, True,
                   calc_grad=True)
    f_ref, g_ref = ref(m0, True)
    assert abs(f - f_ref) <= 1e-10 * abs(f_ref)
    assert np.linalg.norm(g - g_ref) <= 1e-9 * np.linalg.norm(g_ref)
    m_t = np.clip(m0 - 0.05 * np.abs(m0).max() / np.abs(g_ref).max()
                  * g_ref, *lib.bounds(cfg))
    f_t, _, _ = loss(m_t, geoms[1], obs, least_square, dw, mask, True,
                     calc_grad=False)
    assert abs(f_t - ref(m_t, False)[0]) <= 1e-10 * abs(f_t)


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(
        a, np.float64).tobytes()).hexdigest()[:16]


# f at the starting model, the first 16 hex digits of the sha256 of the
# gradient there, the iteration's two objective values, its trials and of
# the accepted model, as the reference read them at float32 on the CPU
# (one thread, seed 2024061125) when the acoustic and elastic objectives
# and the L2 misfit were fixed in objective.py
BEFORE = {
    "tiny-acoustic": (57079.27895539469, "c86f5123624f3163",
                      [57079.27895539469, 15722.623295233852],
                      ["c86f5123624f3163", "5b2c0768f6c93f50"],
                      [28018.333678542254, 18869.319822791418,
                       15722.623295233852, 31740.42018107405],
                      "df92b672a595f30b"),
    "tiny-elastic": (375.10003475259987, "fd5cde77be9aa124",
                     [375.10003475259987, 265.8906374691489],
                     ["fd5cde77be9aa124", "574f8080beb7b66d"],
                     [340.30697262035187, 322.32091933513425,
                      298.77326781394163, 273.4124077169039],
                     "7dc886ab47879797")}


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_reference_by_file_reads_as_before(tree, cell):
    root, here, data_dir = tree
    bench = lib.Bench(root, here=here)
    work = bench.workload(cell)
    cfg = bench.config(cell)
    src, rec = lib.acquisition(cfg, work, 2024061125)
    obj = objective.build(cfg, work, src, rec, data_dir, "cpu", here=here)
    m0 = 1.0 / obj.start_vp.reshape(-1).astype(np.float64) ** 2
    f, g = obj(m0, True)
    ref = lib.follow_reference(obj, m0, cfg, work)
    got = (f, _digest(g), ref["f"], [_digest(x) for x in ref["g"]],
           [t[1] for t in ref["trials"]], _digest(ref["m1"]))
    assert got == BEFORE[cell]
