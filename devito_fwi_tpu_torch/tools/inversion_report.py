"""The q-factor report of SMARMN inversions (port of
``tools/plot_inversions_r5.py``).

    python -m devito_fwi_tpu_torch.tools.inversion_report
        [RESULT_DIR ...] [--data-dir model_data] [--figures DIR]

For each result directory (default: the port's ``result_torch`` and the
JAX system's ``result_r5``), every run under it that holds a final model
``<run>/marmousi_result_misfit_<k>`` and its log ``<run>/log<k>/misfit``
(the layout ``drivers/marmousi_fwi.py`` writes) gives a row: the run, the
misfit (0 L2, 1 W2-1d, 2 W2-2d), the iterations started (lines of the
misfit log), the first and last logged misfit and the final model's
q-factor

    q = 10 log10(|m - m_true|^2 / |m_true|^2),  m = 1 / vp^2,

against ``vp.true``; the starting model (``vp.smooth_20``) heads the
table. A run present in two directories gets the difference of their
q-factors. The table needs only numpy; ``--figures DIR`` also draws the
final models and the normalized misfit curves into DIR with matplotlib
(``utils.plotting``), and raises where matplotlib is missing.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np

from ..drivers._marmousi_common import SMARMN, default_data_dir
from ..models.presets import load_velocity
from ..optimize.math import q_factor

__all__ = ["Run", "find_runs", "q_of", "report", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAMES = {0: "L2", 1: "W2-1d", 2: "W2-2d"}


@dataclass
class Run:
    root: str
    name: str
    misfit: int
    vp: np.ndarray          # final model, km/s
    log: np.ndarray         # (iterations, 2): misfit and max |g|

    @property
    def label(self):
        return "%s/%s" % (os.path.basename(os.path.normpath(self.root)),
                          self.name)


def find_runs(root, shape=SMARMN.shape):
    """The runs under ``root`` with a final model and a misfit log."""
    out = []
    for name in sorted(os.listdir(root)):
        for k in NAMES:
            model = os.path.join(root, name, "marmousi_result_misfit_%d" % k)
            log = os.path.join(root, name, "log%d" % k, "misfit")
            if os.path.isfile(model) and os.path.isfile(log):
                out.append(Run(root, name, k,
                               load_velocity(model, shape),
                               np.atleast_2d(np.loadtxt(log))))
    return out


def q_of(vp, vp_true):
    """q-factor of a velocity model on squared slowness, in dB."""
    return float(q_factor(1.0 / vp.astype(np.float64) ** 2,
                          1.0 / vp_true.astype(np.float64) ** 2))


def _models(data_dir, shape=SMARMN.shape):
    base = os.path.join(data_dir, SMARMN.name)
    return (load_velocity(os.path.join(base, "vp.true"), shape),
            load_velocity(os.path.join(base, "vp.smooth_20"), shape))


def report(roots, data_dir=None, out=print):
    """Print the table; returns {label: q} with "start" for the starting
    model."""
    vt, v0 = _models(data_dir or default_data_dir())
    qs = {"start": q_of(v0, vt)}
    out("%-22s %-6s %5s %11s %11s %9s" % ("run", "misfit", "iters",
                                          "first f", "last f", "q (dB)"))
    out("%-22s %-6s %5s %11s %11s %9.2f" % ("start (vp.smooth_20)", "", "",
                                            "", "", qs["start"]))
    runs = [r for root in roots for r in find_runs(root)]
    for r in runs:
        qs[r.label] = q_of(r.vp, vt)
        out("%-22s %-6s %5d %11.3e %11.3e %9.2f" % (
            r.label, NAMES[r.misfit], r.log.shape[0], r.log[0, 0],
            r.log[-1, 0], qs[r.label]))
    by_name = {}
    for r in runs:
        by_name.setdefault((r.name, r.misfit), []).append(r)
    for (name, _), same in sorted(by_name.items()):
        for a in same[1:]:
            b = same[0]
            out("%s - %s: %+.2f dB" % (b.label, a.label,
                                       qs[b.label] - qs[a.label]))
    return qs


def figures(roots, odir, data_dir=None):
    """The final models beside the true and starting ones, and each run's
    normalized misfit curve, as two PNG files in ``odir``."""
    from ..utils.plotting import _pyplot
    plt, _ = _pyplot()
    vt, v0 = _models(data_dir or default_data_dir())
    runs = [r for root in roots for r in find_runs(root)]
    ext = [0, SMARMN.shape[0] * 0.03, SMARMN.shape[1] * 0.03, 0]
    panels = [("true model", vt), ("start, q=%.2f dB" % q_of(v0, vt), v0)] \
        + [("%s, q=%.2f dB" % (r.label, q_of(r.vp, vt)), r.vp) for r in runs]
    ncol = 2
    nrow = (len(panels) + 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(10, 3 * nrow),
                             squeeze=False)
    for ax, (title, v) in zip(axes.flat, panels):
        im = ax.imshow(v.T, cmap="jet", vmin=1.5, vmax=4.7, extent=ext,
                       aspect="auto")
        ax.set_title(title, fontsize=9)
    fig.colorbar(im, ax=axes, shrink=0.8, label="vp (km/s)")
    os.makedirs(odir, exist_ok=True)
    fig.savefig(os.path.join(odir, "marmousi_models.png"), dpi=110,
                bbox_inches="tight")
    fig2, ax = plt.subplots(1, 1, figsize=(6, 3.2))
    for r in runs:
        ax.semilogy(r.log[:, 0] / r.log[0, 0], "-o", ms=2, label=r.label)
    ax.set_xlabel("iteration")
    ax.legend(fontsize=7)
    fig2.savefig(os.path.join(odir, "misfit_curves.png"), dpi=110,
                 bbox_inches="tight")
    plt.close(fig)
    plt.close(fig2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="*",
                   default=[os.path.join(REPO, "result_torch"),
                            os.path.join(REPO, "result_r5")])
    p.add_argument("--data-dir", default=None)
    p.add_argument("--figures", default=None)
    args = p.parse_args(argv)
    roots = [r for r in args.roots if os.path.isdir(r)]
    qs = report(roots, args.data_dir)
    if args.figures:
        figures(roots, args.figures, args.data_dir)
    return qs


if __name__ == "__main__":
    main()
