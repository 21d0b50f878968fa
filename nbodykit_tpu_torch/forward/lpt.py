"""Lagrangian perturbation theory initial conditions, ZA + 2LPT
(counterpart of ``nbodykit_tpu/forward/lpt.py``).

  ZA:    psi1_i(k) = i k_i / k^2 * delta_k
  2LPT:  S2 = sum_{i<j} [phi_{,ii} phi_{,jj} - phi_{,ij}^2],
         phi_{,ij}(k) = k_i k_j / k^2 * delta_k,
         psi2_i(k) = i k_i / k^2 * S2(k)

with Einstein-de-Sitter growth (the gauge of the KDK stepper in pm.py):

  x(q, a) = q + D1 psi1 + D2 psi2,    D1 = a,  D2 = -(3/7) a^2
  p(q, a) = a^{3/2} (psi1 - (6/7) a psi2)

Particles sit on the mesh lattice (one a cell, shift 0), so the
displacement at a particle is a reshape of the displacement field.
Every function is differentiable in the modes.
"""

import numpy as np
import torch


def _k_inv_k2(pm):
    """k-vectors and the zero-safe 1/k^2 on the transposed complex
    layout, in the mesh dtype."""
    kx, ky, kz = pm.k_list()
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    inv = torch.where(k2 == 0, 0.0, 1.0 / torch.where(k2 == 0, 1.0, k2))
    return (kx, ky, kz), inv


def linear_amplitude(pm, linear_power):
    """sqrt(P(k)/V) on the complex mesh: the scaling that turns a
    unit-variance hermitian whitenoise field into linear density modes.
    ``linear_power`` is P(k) in box units, callable on |k|; the DC mode
    is zero (P is never evaluated at k = 0)."""
    kx, ky, kz = pm.k_list()
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    kmag = torch.sqrt(torch.where(k2 == 0, 1.0, k2))
    V = float(np.prod(pm.BoxSize))
    power = torch.where(k2 == 0, 0.0, linear_power(kmag))
    return torch.sqrt(torch.clamp(power, min=0.0) / V)


def linear_modes(pm, linear_power, seed):
    """Gaussian linear density modes delta_k for a power spectrum:
    ``generate_whitenoise`` (JAX's threefry draw) scaled by
    :func:`linear_amplitude`."""
    eta = pm.generate_whitenoise(seed)
    return eta * linear_amplitude(pm, linear_power)


def modes_from_white(pm, white, amp):
    """The differentiable map from a real whitenoise field (the
    inference leaf, one number a cell) to linear modes: ``r2c`` is
    forward-normalized, so sqrt(Ntot) restores unit variance a mode."""
    return pm.r2c(white) * np.sqrt(pm.Ntot) * amp


def lpt_displacements(pm, delta_k, order=2):
    """ZA (and with ``order=2`` 2LPT) displacement fields on the mesh:
    (psi1, psi2), lists of three real fields each (psi2 is None for
    order 1)."""
    if order not in (1, 2):
        raise ValueError("order must be 1 (ZA) or 2 (2LPT)")
    kv, inv = _k_inv_k2(pm)
    psi1 = [pm.c2r(1j * kv[i] * inv * delta_k) for i in range(3)]
    if order == 1:
        return psi1, None
    diag = [pm.c2r(kv[i] * kv[i] * inv * delta_k) for i in range(3)]
    src = (diag[0] * diag[1] + diag[0] * diag[2] + diag[1] * diag[2])
    for i, j in ((0, 1), (0, 2), (1, 2)):
        od = pm.c2r(kv[i] * kv[j] * inv * delta_k)
        src = src - od * od
    src_k = pm.r2c(src)
    psi2 = [pm.c2r(1j * kv[i] * inv * src_k) for i in range(3)]
    return psi1, psi2


def lpt_init(pm, delta_k, a=0.1, order=2, growth=None):
    """Particle (positions, momenta) at scale factor ``a`` from linear
    modes, one particle a mesh cell (box units), in the raster order of
    ``generate_uniform_particle_grid(shift=0)``.

    ``growth`` is None (the EdS closed forms) or a
    :class:`~.pm.GrowthTable` (LCDM):
    x = q + D1 psi1 + D2 psi2, p = a^2 E(a) (f1 D1 psi1 + f2 D2 psi2).
    """
    psi1, psi2 = lpt_displacements(pm, delta_k, order=order)
    cdt = pm.torch_compute_dtype
    q = pm.generate_uniform_particle_grid(shift=0.0, dtype=cdt)
    d1 = torch.stack([p.reshape(-1).to(cdt) for p in psi1], dim=-1)
    if growth is not None:
        af = float(a)
        D1, f1 = growth.D1(af), growth.f1(af)
        pre = af ** 2 * growth.E(af)
        pos = q + D1 * d1
        mom = pre * f1 * D1 * d1
        if psi2 is not None:
            d2 = torch.stack([p.reshape(-1).to(cdt) for p in psi2],
                             dim=-1)
            D2, f2 = growth.D2(af), growth.f2(af)
            pos = pos + D2 * d2
            mom = mom + pre * f2 * D2 * d2
        return pos, mom
    a = torch.as_tensor(a, dtype=cdt, device=pm.device)
    pos = q + a * d1
    mom = a ** 1.5 * d1
    if psi2 is not None:
        d2 = torch.stack([p.reshape(-1).to(cdt) for p in psi2], dim=-1)
        pos = pos + (-3.0 / 7.0) * a ** 2 * d2
        mom = mom + a ** 1.5 * (-6.0 / 7.0) * a * d2
    return pos, mom
