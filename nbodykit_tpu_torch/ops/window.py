"""Particle-mesh resampling windows and their Fourier-space compensation
(counterpart of ``nbodykit_tpu/ops/window.py``).

Supported windows (B-spline family), with support s:

  nnb (s=1): W(d) = 1,                         |d| < 1/2
  cic (s=2): W(d) = 1 - |d|,                   |d| < 1
  tsc (s=3): W(d) = 3/4 - d^2                  |d| <= 1/2
             W(d) = (3/2 - |d|)^2 / 2          1/2 < |d| < 3/2
  pcs (s=4): W(d) = (4 - 6 d^2 + 3|d|^3)/6     |d| <= 1
             W(d) = (2 - |d|)^3 / 6            1 < |d| < 2

The operations are written in the JAX package's order (one rounding
per operation), so the weights agree with it to the last bit or two;
the deposit kernel in ``csrc/paint_deposit.cu`` evaluates the same
expressions.

The ops are also chosen so that ``torch.autograd`` differentiates the
windows as ``jax.grad`` does at their kinks, where a particle sits on
a node (every particle of the forward model's lattice at zero
displacement): ``|x|`` is ``where(x >= 0, x, -x)`` (derivative 1 at 0,
JAX's ``abs``) and ``max(t, 0)`` is ``torch.maximum`` (a tie splits the
gradient in half, as ``jnp.maximum`` does; ``clamp`` would give it
all to ``t``).
"""

import math

import torch

RESAMPLERS = {'nnb': 1, 'cic': 2, 'tsc': 3, 'pcs': 4}


def window_support(resampler):
    """The support (number of cells touched per axis) of a window."""
    try:
        return RESAMPLERS[resampler]
    except KeyError:
        raise ValueError("unknown resampler %r; choose from %s"
                         % (resampler, sorted(RESAMPLERS)))


def window_base(x, resampler):
    """Index (int32) of the FIRST neighbour cell (offset a=0) of the
    window at cell coordinate ``x``; the stencil is base + [0, s)."""
    s = window_support(resampler)
    if s % 2 == 0:
        return torch.floor(x).to(torch.int32) - (s // 2 - 1)
    return torch.floor(x + 0.5).to(torch.int32) - (s - 1) // 2


def bspline(d, s):
    """B-spline window value at |distance| ``d`` (cell units) for
    support ``s``."""
    if s == 1:
        return torch.ones_like(d)
    zero = d.new_zeros(())
    if s == 2:
        return torch.maximum(1.0 - d, zero)
    if s == 3:
        t = torch.maximum(1.5 - d, zero)
        return torch.where(d <= 0.5, 0.75 - d * d, 0.5 * (t * t))
    t = torch.maximum(2.0 - d, zero)
    return torch.where(d <= 1.0,
                       (4.0 - 6.0 * d * d + 3.0 * (d * d * d)) / 6.0,
                       (t * t * t) / 6.0)


def bspline_deriv(d, s):
    """dW/dd of :func:`bspline` at |distance| ``d`` (cell units): the
    JAX package's piecewise derivative, with its choices at the
    kinks."""
    if s == 1:
        return torch.zeros_like(d)
    zero = d.new_zeros(())
    if s == 2:
        return torch.where(d < 1.0, -torch.ones_like(d), zero)
    if s == 3:
        return torch.where(d <= 0.5, -2.0 * d,
                           -torch.maximum(1.5 - d, zero))
    t = torch.maximum(2.0 - d, zero)
    return torch.where(d <= 1.0, (-12.0 * d + 9.0 * d * d) / 6.0,
                       -0.5 * (t * t))


def _stencil(x, resampler):
    s = window_support(resampler)
    base = window_base(x, resampler)
    offs = torch.arange(s, dtype=torch.int32, device=x.device)
    idx = base[..., None] + offs
    return s, idx, x[..., None] - idx.to(x.dtype)


def window_weights_grad(x, resampler):
    """Per-axis neighbour indices and dW/dx weights (cell units), the
    derivative companion of :func:`window_weights` that the gradient
    readout (``ops/paint.py`` ``grad_axis``) uses:
    dw = W'(|x - idx|) * sign(x - idx)."""
    s, idx, delta = _stencil(x, resampler)
    return idx, bspline_deriv(torch.abs(delta), s) * torch.sign(delta)


def window_weights(x, resampler):
    """Per-axis neighbour indices (int32, NOT wrapped) and weights,
    shapes (..., s), for particles at cell coordinate ``x``."""
    s, idx, delta = _stencil(x, resampler)
    d = torch.where(delta >= 0, delta, -delta)
    return idx, bspline(d, s)


def _sinc(x):
    # sin(x)/x with the removable singularity filled
    return torch.sinc(x / math.pi)


def compensation_transfer(resampler, interlaced):
    """The Fourier-space compensation ``transfer(w, v)`` that divides
    ``v`` by prod_i C(w_i), with ``w`` the circular frequencies
    k_i * BoxSize_i / Nmesh_i in [-pi, pi). Interlaced: the pure
    Jing-05 eq.18 sinc^p; otherwise the eq.20 first-order
    aliasing-corrected forms (nnb always takes the plain sinc).
    ``transfer(w, v, inplace=True)`` divides ``v`` itself."""
    p = window_support(resampler)
    if resampler == 'nnb':
        interlaced = True

    if interlaced:
        def C(wi):
            return _sinc(0.5 * wi) ** p
    else:
        if resampler == 'cic':
            def C(wi):
                return (1.0 - 2.0 / 3 * torch.sin(0.5 * wi) ** 2) ** 0.5
        elif resampler == 'tsc':
            def C(wi):
                s2 = torch.sin(0.5 * wi) ** 2
                return (1.0 - s2 + 2.0 / 15 * s2 ** 2) ** 0.5
        elif resampler == 'pcs':
            def C(wi):
                s2 = torch.sin(0.5 * wi) ** 2
                return (1.0 - 4.0 / 3.0 * s2 + 2.0 / 5.0 * s2 ** 2
                        - 4.0 / 315.0 * s2 ** 3) ** 0.5

    def transfer(w, v, inplace=False):
        for i in range(3):
            v = v.div_(C(w[i])) if inplace else v / C(w[i])
        return v

    return transfer
