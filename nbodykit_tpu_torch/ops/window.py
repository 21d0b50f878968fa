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
    if s == 2:
        return torch.clamp(1.0 - d, min=0.0)
    if s == 3:
        t = torch.clamp(1.5 - d, min=0.0)
        return torch.where(d <= 0.5, 0.75 - d * d, 0.5 * (t * t))
    t = torch.clamp(2.0 - d, min=0.0)
    return torch.where(d <= 1.0,
                       (4.0 - 6.0 * d * d + 3.0 * (d * d * d)) / 6.0,
                       (t * t * t) / 6.0)


def window_weights(x, resampler):
    """Per-axis neighbour indices (int32, NOT wrapped) and weights,
    shapes (..., s), for particles at cell coordinate ``x``."""
    s = window_support(resampler)
    base = window_base(x, resampler)
    offs = torch.arange(s, dtype=torch.int32, device=x.device)
    idx = base[..., None] + offs
    d = torch.abs(x[..., None] - idx.to(x.dtype))
    return idx, bspline(d, s)


def _sinc(x):
    # sin(x)/x with the removable singularity filled
    return torch.sinc(x / math.pi)


def compensation_transfer(resampler, interlaced):
    """The Fourier-space compensation ``transfer(w, v)`` that divides
    ``v`` by prod_i C(w_i), with ``w`` the circular frequencies
    k_i * BoxSize_i / Nmesh_i in [-pi, pi). Interlaced: the pure
    Jing-05 eq.18 sinc^p; otherwise the eq.20 first-order
    aliasing-corrected forms (nnb always takes the plain sinc)."""
    p = window_support(resampler)
    if resampler == 'nnb':
        interlaced = True

    if interlaced:
        def transfer(w, v):
            for i in range(3):
                v = v / _sinc(0.5 * w[i]) ** p
            return v
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

        def transfer(w, v):
            for i in range(3):
                v = v / C(w[i])
            return v

    return transfer
