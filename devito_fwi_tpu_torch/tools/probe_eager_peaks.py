"""Device memory of the elastic and viscoacoustic objectives' eager routes.

    python -m devito_fwi_tpu_torch.tools.probe_eager_peaks

For one shot (``chip_smoke.ROUTE_SHOT``) of SMARM2 (elastic) and SMARMN
(viscoacoustic sls/2) at full width, each at ``chip_smoke.CUT_STEPS`` steps
and at the driver's nt, and for the five other Q kernels at the cut nt, the
script runs ``*_fwi_obj_multi`` on the "saved" and "vjp" routes on the card
and prints, in grid fields of the padded model: the whole call's peak
device allocation, the peak of its shot chunk alone (``chip_smoke
.chunk_peaks``) and the bytes a shot its chunks are sized with
(``_eager_bytes_per_shot``), with the segment layout. The observed data
are zeros: the routes' memory does not depend on them, and no kernel is
built. Run from the repository root; needs one card (about two minutes).
"""
from __future__ import annotations

import os
import sys
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _zeros_obs(g):
    nrec = g.rec_positions.shape[0]
    return [types.SimpleNamespace(data=np.zeros((g.nt, nrec), np.float32))
            for _ in range(g.nsrc)]


def _measure(smoke, family, mod, g, route, kind, dev, label, **kw):
    from devito_fwi_tpu_torch.ops.remat import segment_layout
    obs = _zeros_obs(g)
    mod._device_stack(obs, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with smoke.chunk_peaks(mod, smoke.EAGER_CHUNKS[family], dev) as (
            chunks, whole):
        getattr(mod, f"{family}_fwi_obj_multi")(
            g, obs, calc_grad=True, shot_indices=[smoke.ROUTE_SHOT],
            grad_route=route, device="cuda", **kw)
    sec = time.perf_counter() - t0
    st = mod._Setup(g, dev, [smoke.ROUTE_SHOT])
    field = int(np.prod(st.damp.shape)) * 4
    if family == "elastic":
        sized = mod._eager_bytes_per_shot(st, True, "least_square", route, 0)
        nsteps = st.nsteps
    else:
        sized = mod._eager_bytes_per_shot(st, True, "least_square", route,
                                          kind, 0)
        nsteps = st.nt - 1 - (kind[1] - 1)
    seg, nseg = segment_layout(nsteps, 0)
    print(f"{label} {route}, nt {g.nt} (seg {seg}, nseg {nseg}): call peak "
          f"{(whole[0] - base) / field:.1f} fields, chunk "
          f"{chunks[0] / field:.1f}, sized {sized / field:.1f} "
          f"({chunks[0] / 1e9:.4f} GB against {sized / 1e9:.4f}); "
          f"{sec:.1f} s", flush=True)


def main():
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from devito_fwi_tpu_torch import elastic_fwi, visco_fwi
    from devito_fwi_tpu_torch.drivers import _marmousi_common as marm
    from devito_fwi_tpu_torch.ops.viscoacoustic import KERNELS
    if not torch.cuda.is_available():
        print("probe_eager_peaks: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(smoke.card_line(), flush=True)

    args = marm.make_parser(marm.SMARM2).parse_args(
        ["--physics", "elastic", "--device", "cuda"])
    _, geoms, fields, _ = marm.setup_elastic(
        marm.SMARM2, args, marm.SMARM2.nsrc_default)
    _, vp, vs, rho = fields
    for g in (*smoke.cut_geometries(geoms[1]), geoms[1]):
        for route in ("vjp", "saved"):
            _measure(smoke, "elastic", elastic_fwi, g, route, None, dev,
                     "SMARM2 elastic", vp=vp, vs=vs, rho=rho)

    args = marm.make_parser(marm.SMARMN).parse_args(
        ["--physics", "viscoacoustic", "--device", "cuda"])
    _, geoms, vp, _ = marm.setup_visco(marm.SMARMN, args,
                                       marm.SMARMN.nsrc_default)
    cut = smoke.cut_geometries(geoms[1])[0]
    for g in (cut, geoms[1]):
        for route in ("vjp", "saved"):
            _measure(smoke, "visco", visco_fwi, g, route, ("sls", 2), dev,
                     "SMARMN visco sls/2", vp=vp)
    for kind in sorted(KERNELS - {("sls", 2)}):
        _measure(smoke, "visco", visco_fwi, cut, "vjp", kind, dev,
                 f"SMARMN visco {kind[0]}/{kind[1]}", vp=vp, kernel=kind[0],
                 time_order=kind[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
