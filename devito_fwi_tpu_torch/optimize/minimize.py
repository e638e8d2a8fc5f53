"""FWI outer inversion loop.

Parity re-implementation of the reference ``minimize.py``: gradient ->
search direction -> line search with retry/restart -> bounded update ->
stopping rule ``fkp1/f0 < ftol``, with the same artifact dumps (model /
gradient / residual snapshots, misfit log, sim_count accounting).

Divergence from the reference (documented): the reference asserts
``optimizer.name in ['LBFGS','NLCG','SteepestDescent']`` while its own
SteepestDescent reports ``'steepest descent'`` — here the names agree so
steepest descent actually works with the loop.
"""
from __future__ import annotations

import os

import numpy as np

from ..fwi import fwi_loss
from ..utils.profiling import span
from .tools import append_text, write_array

__all__ = ["minimize"]


def divides(i, j):
    """True if j divides i (reference ``minimize.py:6-13``, with the
    ``j is 0`` identity-comparison bug fixed)."""
    if j == 0:
        return False
    return i % j == 0


class minimize:
    def __init__(self, optimizer, maxIter=10, ftol=1e-2, gtol=1e-3,
                 log_path="./log", save_model_freq=5, save_grad_freq=5,
                 save_res_freq=10, checkpoint_freq=1, resume=False,
                 batch_size=None, batch_seed=0, loss_fn=None):
        assert optimizer.name in ("LBFGS", "NLCG", "SteepestDescent")
        self.optimizer = optimizer
        # pluggable objective with the fwi_loss signature — e.g.
        # elastic_fwi.ElasticFwiLoss drives an elastic inversion through
        # the same outer loop (default: the acoustic fwi_loss)
        self.loss_fn = loss_fn if loss_fn is not None else fwi_loss
        self.ftol = ftol
        self.gtol = gtol
        self.maxIter = maxIter
        self.log_path = log_path
        self.save_model_freq = save_model_freq
        self.save_grad_freq = save_grad_freq
        self.save_res_freq = save_res_freq
        # state persistence with actual resume (the reference dumps
        # snapshots but cannot resume — SURVEY.md §5)
        self.checkpoint_freq = checkpoint_freq
        self.resume = resume
        # random-batch FWI (Hu et al., arXiv:2110.06455; not in the
        # reference): each iteration evaluates the gradient AND its
        # line-search trials on a random shot subset of this size. The
        # selection is seeded by (batch_seed, iteration), so a resumed
        # run replays the same subsets. The ftol stopping rule then
        # compares stochastic objectives — use more iterations and a
        # tighter ftol than a full-batch run.
        self.batch_size = batch_size
        self.batch_seed = batch_seed
        self.ckpt_path = os.path.join(log_path, "checkpoint")
        resuming = bool(resume and self._latest_ckpt())
        # a resumed inversion must APPEND to its pre-interrupt metric
        # files and optim_info table, not wipe them
        self.optimizer.setup(resume=resuming)
        if not resuming:
            self.check_path()

    def _latest_ckpt(self):
        from .checkpoint import latest_checkpoint
        return latest_checkpoint(self.ckpt_path)

    def run(self, m, geometry, obs_data, misfit_func, direct_wave=None,
            mask=None, precond=True, bounds=None):
        iter_count = 0
        if self.resume:
            from .checkpoint import load_state
            ck = self._latest_ckpt()
            if ck:
                iter_count, m, self.f0 = load_state(ck, self.optimizer)
                print("Resumed from %s at iteration %d" % (ck, iter_count))
        nsrc_all = geometry.nsrc
        while iter_count < self.maxIter:
            print("Starting iteration", iter_count + 1)
            sel = None
            if self.batch_size and self.batch_size < nsrc_all:
                rng = np.random.default_rng(
                    (self.batch_seed, iter_count))
                sel = np.sort(rng.choice(nsrc_all, self.batch_size,
                                         replace=False))
                print("\t random batch: shots", sel.tolist())
            print("\t Computing gradient")
            fval, g, res = self.loss_fn(m, geometry, obs_data, misfit_func,
                                        direct_wave, mask, precond,
                                        shot_indices=sel)
            if not np.isfinite(fval):
                # a non-finite objective at the CURRENT model cannot be
                # line-searched away (every trial starts from m):
                # restarting would loop forever on the same NaN (this
                # bit the elastic driver when a step-len-max clamped,
                # never-evaluated step landed beyond the pinned dt's
                # CFL limit). Abort with the last finite model.
                print(" Non-finite objective at the current model "
                      "(f=%r) — the previous accepted step left the "
                      "stable regime. Aborting with the last model." %
                      fval)
                return m
            if iter_count == 0:
                self.f0 = fval
            with span("loop.dumps"):
                self.save_misfit(fval, g)
                if divides(iter_count, self.save_grad_freq):
                    self.save_gradient(g, iter_count)
                if divides(iter_count, self.save_res_freq):
                    self.save_residual(res, iter_count)
            print("\t Computing search direction")
            with span("loop.direction"):
                p = self.optimizer.compute_direction(m, g)
            print("\t Computing step length")

            do_line_search = True
            while do_line_search:
                with span("loop.search"):
                    alpha = self.optimizer.initialize_search(m, g, p, fval)
                while True:
                    print(" trial step",
                          self.optimizer.line_search.step_count + 1)
                    with span("loop.search"):
                        m_temp = self.apply_bounds(m + alpha * p, bounds)
                    fval_try, _, _ = self.loss_fn(
                        m_temp, geometry, obs_data, misfit_func,
                        direct_wave, mask, precond, calc_grad=False,
                        shot_indices=sel)
                    print("\t fval_try: %10.3e" % fval_try)
                    with span("loop.search"):
                        alpha, status = self.optimizer.update_search(
                            alpha, fval_try)
                        if status > 0:
                            self.optimizer.finalize_search(g, p)
                        elif status < 0:
                            retry = self.optimizer.retry_status(g, p)
                            if retry:
                                self.optimizer.restart()
                    if status > 0:
                        do_line_search = False
                        break
                    elif status == 0:
                        continue
                    elif status < 0:
                        if retry:
                            print(" Line search failed\n\n Retrying...")
                            break
                        else:
                            print(" Line search failed\n\n Aborting...")
                            return m
            with span("loop.search"):
                m = self.apply_bounds(m + alpha * p, bounds)

            if divides(iter_count + 1, self.checkpoint_freq):
                from .checkpoint import save_state
                with span("loop.checkpoint"):
                    save_state(self.ckpt_path, iter_count + 1, m, self.f0,
                               self.optimizer)
            with span("loop.dumps"):
                stop = self.finalize(m, g, fval, fval_try, iter_count)
            print("")
            if stop:
                return m
            iter_count += 1
        return m

    def apply_bounds(self, x, bounds):
        if bounds is None:
            return x
        if len(bounds) != 2:
            raise ValueError("The bounds should only have two values")
        x = np.asarray(x)
        x[x < bounds[0]] = bounds[0]
        x[x > bounds[1]] = bounds[1]
        return x

    def finalize(self, m, g, fk, fkp1, iter_count):
        self.write_count()
        if divides(iter_count, self.save_model_freq):
            self.save_model(m, iter_count)
        return self.check_stopping_criteria(fk, fkp1, g)

    def check_stopping_criteria(self, fk, fkp1, g):
        """Stop when fkp1/f0 < ftol (reference ``minimize.py:113-128``)."""
        return 1 if fkp1 / self.f0 < self.ftol else 0

    def save_model(self, m, k):
        v = 1. / np.sqrt(m)
        path = os.path.join(self.log_path, "model_est")
        os.makedirs(path, exist_ok=True)
        write_array(v.astype(np.float32), os.path.join(path, "v_" + str(k)))

    def save_gradient(self, g, k):
        path = os.path.join(self.log_path, "gradient")
        os.makedirs(path, exist_ok=True)
        write_array(np.asarray(g).astype(np.float32),
                    os.path.join(path, "g_" + str(k)))

    def save_misfit(self, fval, g):
        file = os.path.join(self.log_path, "misfit")
        norm_g = np.max(np.abs(g))
        append_text(file, "%10.3e  %10.3e\n" % (fval, norm_g))
        print("\t\t f: %10.3e \t |g|: %10.3e" % (fval, norm_g))

    def save_residual(self, res, k):
        path = os.path.join(self.log_path, "residual", str(k))
        os.makedirs(path, exist_ok=True)
        for i, r in enumerate(res):
            write_array(np.asarray(r).astype(np.float32),
                        os.path.join(path, "res" + str(i)))

    def check_path(self):
        with span("loop.dumps"):
            os.makedirs(self.log_path, exist_ok=True)
            file = os.path.join(self.log_path, "misfit")
            if os.path.exists(file):
                os.remove(file)

    def write_count(self):
        """Simulation-count accounting (reference ``minimize.py:166-178``)."""
        count = 0
        if self.optimizer.name in ("SteepestDescent", "NLCG"):
            count = 3 + self.optimizer.line_search.step_count
        elif self.optimizer.name == "LBFGS":
            if self.optimizer.call_count == 1:
                count = 3 + self.optimizer.line_search.step_count
            else:
                count = 2 + self.optimizer.line_search.step_count
        self.optimizer.writer("sim_count", count)
