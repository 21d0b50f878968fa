"""Grad-safe paint: the adjoint contract of each paint kernel
(counterpart of ``nbodykit_tpu/forward/adjoint.py``).

The paint/readout pair is adjoint (the VJP of a scatter-add is a
gather), so painting needs no new kernel for its backward pass. What
differs per paint method is whether autograd can run through the
forward:

  scatter          ``index_add_`` has a backward: used as it runs.
  sort / segsum /  wrapped in :class:`PaintAdjoint`, a
  streams          ``torch.autograd.Function``: the kernel's forward,
                   the analytic readout backward (the JAX package's
                   ``jax.custom_vjp``; ``adjoint_mode='custom_vjp'``).
  mxu              the hand deposit has no backward: demoted to
                   ``scatter`` by ``resolve_paint(differentiable=True)``
                   (``source='grad-fallback'``, one warning).

Across ranks both run through the paint's exchange and halo rows, each
collective with its adjoint (``parallel/``); the analytic backward reads
out all four values of a particle in one routing (``readout_many``).

The analytic backward, for out = paint(pos, mass) and cotangent g:

  d/dmass  = readout(g, pos)
  d/dpos_d = mass * readout(g, pos, grad_axis=d) * Nmesh_d / Box_d
"""

import numpy as np
import torch

from .. import option_scope, resolve_paint, DIFFERENTIABLE_PAINT

# paint methods wrapped in PaintAdjoint (the JAX package's
# GRAD_WRAPPED_PAINT)
GRAD_WRAPPED_PAINT = frozenset({'sort', 'segsum', 'streams'})


def resolve_forward_paint(pm, npart):
    """The paint configuration of a grad workload and its adjoint mode,
    ``(cfg, mode)`` with mode ``'native'`` (autograd runs through the
    paint) or ``'custom_vjp'`` (:class:`PaintAdjoint`). A method with
    neither is demoted through the grad-mode resolution. ``npart`` is
    accepted for the JAX signature (the port has no tuner to ask)."""
    cfg = resolve_paint(pm.device)
    method = cfg['paint_method']
    if method in DIFFERENTIABLE_PAINT:
        return cfg, 'native'
    if method in GRAD_WRAPPED_PAINT:
        return cfg, 'custom_vjp'
    return resolve_paint(pm.device, differentiable=True), 'native'


class PaintAdjoint(torch.autograd.Function):
    """``run(pos, mass)`` forward, the readout adjoint backward.

    ``apply(pos, mass, run, pm, resampler)``: ``pos`` (n, 3) box units,
    ``mass`` (n,); ``run`` paints them on ``pm``'s mesh."""

    @staticmethod
    def forward(ctx, pos, mass, run, pm, resampler):
        ctx.save_for_backward(pos, mass)
        ctx.pm, ctx.resampler = pm, resampler
        return run(pos, mass)

    @staticmethod
    def backward(ctx, cot):
        pos, mass = ctx.saved_tensors
        pm, resampler = ctx.pm, ctx.resampler
        g = cot.to(pm.torch_compute_dtype)
        scale = np.asarray(pm.Nmesh, 'f8') / np.asarray(pm.BoxSize, 'f8')
        # one routing for the value and the three derivatives
        vals = pm.readout_many([g] * 4, pos, resampler=resampler,
                               grad_axis=[None, 0, 1, 2])
        dmass = vals[0]
        dpos = torch.stack([vals[1 + d] * float(scale[d])
                            for d in range(3)], dim=-1)
        dpos = dpos * mass[:, None]
        return dpos.to(pos.dtype), dmass.to(mass.dtype), None, None, None


def make_paint(pm, npart, resampler='cic', method=None):
    """A differentiable ``paint(pos, mass=1.0) -> mesh`` over ``pm`` for
    ``npart`` particles, and its configuration ``cfg`` (with
    ``cfg['adjoint_mode']`` and ``cfg['paint_method']``, the method
    every call runs: the paint options are captured here and set around
    each call).

    ``method`` pins a paint kernel instead of resolving one; a method
    with no adjoint contract (``'mxu'``) is a ValueError here: only the
    resolver demotes."""
    if method is not None:
        cfg = dict(resolve_paint(pm.device), paint_method=method,
                   source='explicit')
        if method in DIFFERENTIABLE_PAINT:
            mode = 'native'
        elif method in GRAD_WRAPPED_PAINT:
            mode = 'custom_vjp'
        else:
            raise ValueError(
                "paint method %r has no adjoint contract; use the "
                "resolver (method=None) for the grad fallback" % method)
    else:
        cfg, mode = resolve_forward_paint(pm, npart)
    cfg = dict(cfg, adjoint_mode=mode)
    opts = {k: cfg[k] for k in ('paint_method', 'paint_chunk_size',
                                'paint_streams')}
    cdt = pm.torch_compute_dtype

    def _run(pos, mass):
        with option_scope(**opts):
            return pm.paint(pos, mass, resampler=resampler)

    def _mass(pos, mass):
        return torch.as_tensor(mass, dtype=cdt, device=pos.device).expand(
            pos.shape[0])

    if mode == 'native':
        def paint_fn(pos, mass=1.0):
            return _run(pos, _mass(pos, mass))
    else:
        def paint_fn(pos, mass=1.0):
            return PaintAdjoint.apply(pos, _mass(pos, mass), _run, pm,
                                      resampler)
    paint_fn.method = cfg['paint_method']
    return paint_fn, cfg
