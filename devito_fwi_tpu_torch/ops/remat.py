"""Checkpointed time loop for autograd through the eager forwards.

Port of the two-level ``jax.checkpoint`` scans of
``devito_fwi_tpu.ops.staggered.elastic_forward_seg`` /
``viscoelastic_forward_seg`` and ``ops.viscoacoustic.forward_seg``. The
steps are split into ``nseg`` segments of ``seg`` steps (the JAX layout:
``n_checkpoints <= 0`` means ``max(1, int(sqrt(nsteps)))``, ``seg =
ceil(nsteps / n_checkpoints)``, ``nseg = ceil(nsteps / seg)``). Under
autograd each segment is one node (``_Segment``): its forward runs the
steps without a graph and keeps only the segment's start, and its
backward runs them again with a graph and takes that graph's
vector-Jacobian product, so the backward pass holds one segment's graph
at a time. This is ``torch.utils.checkpoint`` in its reentrant form, with
the parameters as explicit inputs so that ``torch.autograd.grad`` reaches
them; the non-reentrant form's saved-tensor hooks cost three times the
plain step loop. The JAX scan pads the last segment with zero-source
steps and masks them out of the illumination; here the last segment stops
at ``nsteps``, which leaves every output the same. The JAX code's inner
per-step ``jax.checkpoint`` is not repeated: one segment's graph is what
the backward pass holds.

The illumination is accumulated detached (the JAX code's
``stop_gradient``), an output of each segment that carries no gradient.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["segment_layout", "checkpointed_loop"]


def segment_layout(nsteps, n_checkpoints):
    """(seg, nseg): the steps a segment and the segments of ``nsteps``
    steps for ``n_checkpoints`` (<= 0: about sqrt(nsteps) segments)."""
    if n_checkpoints <= 0:
        n_checkpoints = max(1, int(np.sqrt(nsteps)))
    seg = -(-nsteps // n_checkpoints)
    return seg, -(-nsteps // seg)


def _segment(step, energy, src, carry, illum):
    outs = []
    for src_t in src:
        carry, out = step(carry, src_t)
        outs.append(out)
        with torch.no_grad():
            illum = illum + energy(carry)
    return carry, tuple(torch.stack(o) for o in zip(*outs)), illum


class _Segment(torch.autograd.Function):
    """One segment as one autograd node. ``run(*tensors)`` maps (the
    parameters, the flat carry, the segment's sources, illum) to (the flat
    carry, the stacked outputs, illum)."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        with torch.no_grad():
            out = run(*tensors)
        ctx.mark_non_differentiable(out[-1])
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[1:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.run(*inputs)
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True) if pairs
                   else [None] * len(wrt))
        return (None,) + tuple(next(got) if n else None for n in needs)


def checkpointed_loop(make_step, params, carry, src, illum, *,
                      n_checkpoints, energy):
    """Run ``carry, out_t = step(carry, src[k])`` over the rows of ``src``
    in checkpointed segments, ``step = make_step(*params)`` built from the
    parameter tensors (again in each segment's backward, so the gradient
    reaches them). ``out_t`` is a tuple of tensors; ``energy(carry)`` the
    field each step adds to the detached ``illum``. Returns (final carry,
    the outputs stacked over the steps, illum). Without autograd
    (``torch.no_grad``, or nothing that requires a gradient) the segments
    run as one loop."""
    nsteps = src.shape[0]
    seg, nseg = segment_layout(nsteps, n_checkpoints)
    flat, spec = tree_flatten(carry)
    if not (torch.is_grad_enabled() and
            any(t.requires_grad for t in list(params) + flat)):
        carry, outs, illum = _segment(make_step(*params), energy, src,
                                      carry, illum)
        return carry, outs, illum
    npar, ncar = len(params), len(flat)

    def run(*tensors):
        c = tree_unflatten(list(tensors[npar:npar + ncar]), spec)
        c, outs, il = _segment(make_step(*tensors[:npar]), energy,
                               tensors[-2], c, tensors[-1])
        return (*tree_flatten(c)[0], *outs, il)

    parts = []
    for k in range(nseg):
        out = _Segment.apply(run, *params, *flat, src[k * seg:(k + 1) * seg],
                             illum)
        flat, outs, illum = list(out[:ncar]), out[ncar:-1], out[-1]
        parts.append(outs)
    carry = tree_unflatten(flat, spec)
    return carry, tuple(torch.cat(o) for o in zip(*parts)), illum
