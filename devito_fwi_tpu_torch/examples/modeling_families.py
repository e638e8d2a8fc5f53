"""Forward modeling across the six physics families:

    python -m devito_fwi_tpu_torch.examples.modeling_families [-nd 2]
        [-tn 1000] [-so 4] [--device cpu]

Port of ``examples/modeling_families.py`` (the reference's per-family
example scripts ``seismic/{acoustic,tti,elastic,viscoelastic,
viscoacoustic,self_adjoint}/*_example.py``): the same demo models (50
cells a side at 20 m, two dimensions unless ``-d`` gives a shape), each
family's forward solver on ``--device`` (cuda by default), and the norm
of each receiver gather, which must be finite. On the card the elastic
forward and the viscoacoustic sls/2 forward run their kernels
(``csrc/elastic2d.cu``, ``csrc/visco2d.cu``); the acoustic, TTI,
viscoelastic and self-adjoint forwards run the eager torch operators on
the card, as the JAX solvers run their XLA scans.
"""
from __future__ import annotations

import numpy as np

from ..models.geometry import seismic_args, setup_geometry
from ..models.presets import demo_model
from ..ops.elastic_wavesolver import ElasticWaveSolver, ViscoelasticWaveSolver
from ..ops.sa_wavesolver import acoustic_sa_setup
from ..ops.tti_wavesolver import AnisotropicWaveSolver
from ..ops.viscoacoustic_wavesolver import ViscoacousticWaveSolver
from ..ops.wavesolver import AcousticWaveSolver

__all__ = ["FAMILIES", "family", "families", "main"]

FAMILIES = ("acoustic (OT2)", "TTI (centered)", "elastic",
            "viscoelastic (SLS)", "viscoacoustic (sls-2)", "self-adjoint w/Q")


def family(name, shape, spacing, tn, so, device="cuda"):
    """The receiver gather (numpy) of one family's forward, as the JAX
    example builds it."""
    def model(preset, nbl, order=so):
        return demo_model(preset, shape=shape, spacing=spacing,
                          space_order=order, nbl=nbl)

    if name == "acoustic (OT2)":
        m = model("layers-isotropic", 40)
        rec, _, summary = AcousticWaveSolver(
            m, setup_geometry(m, tn), space_order=so,
            device=device).forward()
        print("  acoustic perf:", summary)
        return rec.data
    if name == "TTI (centered)":
        m = model("layers-tti", 10, max(so, 4))
        rec, _, _, _ = AnisotropicWaveSolver(
            m, setup_geometry(m, tn / 2), space_order=max(so, 4),
            device=device).forward()
        return rec.data
    if name == "elastic":
        m = model("layers-elastic", 40)
        rec1, _, _, _, _ = ElasticWaveSolver(
            m, setup_geometry(m, tn), space_order=so,
            device=device).forward()
        return rec1.data
    if name == "viscoelastic (SLS)":
        m = model("layers-viscoelastic", 40)
        rec1, _, _, _, _ = ViscoelasticWaveSolver(
            m, setup_geometry(m, tn), space_order=so,
            device=device).forward()
        return rec1.data
    if name == "viscoacoustic (sls-2)":
        m = model("layers-viscoacoustic", 40)
        rec, _, _, _ = ViscoacousticWaveSolver(
            m, setup_geometry(m, tn), space_order=so, kernel="sls",
            time_order=2, device=device).forward()
        return rec.data
    if name == "self-adjoint w/Q":
        solver = acoustic_sa_setup(shape=shape, spacing=spacing, tn=tn / 2,
                                   space_order=max(so, 8), nbl=10,
                                   device=device)
        rec, _, _ = solver.forward()
        return rec.data
    raise ValueError(f"family {name!r}: expected one of {FAMILIES}")


def families(shape, spacing, tn, so, device="cuda"):
    """{family: |rec|} over the six families; each gather must be finite."""
    norms = {}
    for name in FAMILIES:
        rec = np.asarray(family(name, shape, spacing, tn, so, device))
        norms[name] = float(np.linalg.norm(rec))
        print("%-22s |rec| = %12.6f" % (name, norms[name]))
        assert np.isfinite(rec).all(), name
    return norms


def main(argv=None):
    p = seismic_args("Forward modeling across physics families")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    ndim = min(args.ndim, 2) if tuple(args.shape) == (51, 51, 51) \
        else args.ndim
    shape = tuple([50] * ndim)
    spacing = tuple([20.0] * ndim)
    tn = args.tn if args.tn > 0 else 1000.0
    norms = families(shape, spacing, tn, args.space_order, args.device)
    print("all families finite")
    return norms


if __name__ == "__main__":
    main()
