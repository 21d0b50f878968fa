"""Mock field and catalog generation (counterpart of
``nbodykit_tpu/mockmaker.py``).

Reference: ``nbodykit/mockmaker.py`` — Gaussian realizations (:7,:143),
lognormal transform (:213), Poisson sampling with Zel'dovich
displacement readout (:246). The draws are the JAX package's threefry
draws (:mod:`nbodykit_tpu_torch.rng`), so a seed gives the JAX
package's mock.

Memory: a 1024^3 f4 field is 4.3 GB real or complex. The fields are
built slab by slab and scaled in place, each displacement component is
transformed alone, read only at the occupied cells and freed, and the
Poisson draw yields the occupied cells alone (the kernel's occupied-cells
mode): no count mesh is made.
"""

import numpy as np
import torch

from .base.mesh import Field
from .ops import threefry_cuda
from .rng import key as make_key, split, uniform
from .utils import stage

# ky rows per step of the slab loops over a complex field
_SLAB_ROWS = 64


def _k_slabs(pm):
    """(rows, kx, ky[rows], kz) over ky-slabs of the transposed complex
    layout, in the mesh's real dtype."""
    kx, ky, kz = pm.k_list()
    for a in range(0, ky.shape[0], _SLAB_ROWS):
        yield slice(a, a + _SLAB_ROWS), kx, ky[a:a + _SLAB_ROWS], kz


def apply_power(pm, eta, linear_power, amp_of_power):
    """eta *= amp(P(|k|)) in place, slab by slab, and 0 at k = 0."""
    for rows, kx, ky, kz in _k_slabs(pm):
        k2 = kx ** 2 + ky ** 2 + kz ** 2
        amp = amp_of_power(linear_power(torch.sqrt(k2)))
        slab = eta[rows]
        slab.mul_(amp.to(slab.real.dtype))
        slab.masked_fill_(k2 == 0, 0)
    return eta


def gaussian_complex_fields(pm, linear_power, seed,
                            unitary_amplitude=False, inverted_phase=False,
                            compute_displacement=False):
    """delta_k (and optionally psi_k) for a linear power spectrum.

    delta_k = eta * sqrt(P(k)/V); psi_i(k) = (i k_i / k^2) delta_k.
    Returns (delta_k Field, [psi_x, psi_y, psi_z] Fields or None). The
    lognormal catalog asks for no displacement here and builds one
    component at a time instead (:func:`displacement_component`).
    """
    V = float(np.prod(pm.BoxSize))
    with stage('whitenoise'):
        eta = pm.generate_whitenoise(seed, unitary=unitary_amplitude,
                                     inverted_phase=inverted_phase)
    with stage('power'):
        delta_k = apply_power(
            pm, eta, linear_power,
            lambda p: torch.sqrt(torch.clamp(p, min=0.0) / V))
    disp_k = None
    if compute_displacement:
        disp_k = [Field(displacement_component(pm, delta_k, i)
                        .permute(1, 0, 2), pm, 'complex')
                  for i in range(3)]
    return Field(delta_k, pm, 'complex'), disp_k


def displacement_component(pm, delta_k, axis):
    """psi_axis(k) = where(k = 0, 0, i k_axis / k^2 delta_k), written
    into a new complex field in the natural (N0, N1, N2//2+1) layout,
    ready for :meth:`ParticleMesh.c2r_natural`."""
    N0, N1, N2 = pm.shape_real
    out = torch.empty((N0, N1, N2 // 2 + 1), dtype=delta_k.dtype,
                      device=delta_k.device)
    nat = out.permute(1, 0, 2)                 # (ky, kx, kz) view
    for rows, kx, ky, kz in _k_slabs(pm):
        k2 = kx ** 2 + ky ** 2 + kz ** 2
        kd = (kx, ky, kz)[axis]
        fac = kd / torch.where(k2 == 0, 1.0, k2)
        fac = torch.where(k2 == 0, 0.0, fac)
        val = delta_k[rows] * fac
        nat[rows] = torch.complex(-val.imag, val.real)   # times i
    return out


def gaussian_real_fields(pm, linear_power, seed,
                         unitary_amplitude=False, inverted_phase=False,
                         compute_displacement=False):
    """Real-space delta (and displacement vector fields); reference
    mockmaker.py:143-210."""
    delta_k, _ = gaussian_complex_fields(
        pm, linear_power, seed, unitary_amplitude=unitary_amplitude,
        inverted_phase=inverted_phase)
    disp = None
    if compute_displacement:
        disp = [Field(pm.c2r_natural(displacement_component(
            pm, delta_k.value, i)), pm, 'real') for i in range(3)]
    return delta_k.c2r(), disp


def lognormal_transform(density, bias=1.0):
    """delta -> exp(b*delta), normalized to unit mean (reference
    mockmaker.py:213-243)."""
    value = torch.exp(bias * density.value)
    value = value / value.mean()
    return Field(value, density.pm, 'real')


def lognormal_lambda(delta, pm, nbar, bias):
    """lam = nbar cellvol exp(b_L delta) / mean, in the field's dtype,
    computed in place over ``delta``'s buffer. The Lagrangian bias
    b_L = b - 1: the Zel'dovich displacement supplies the Eulerian +1
    (reference mockmaker.py:289)."""
    lam = delta.mul_(bias - 1.0).exp_()
    lam.div_(lam.mean())
    return lam.mul_(nbar * float(np.prod(pm.cellsize)))


def poisson_cells(lam, seed, expected):
    """(occupied cell ids in raster order, their counts, Ntot): the
    JAX package's ``poisson(split(key(seed))[0], lam)``, reduced to the
    occupied cells. On the card the Poisson kernel writes that list in
    the launch that draws the counts (no count mesh, one host read);
    ``expected``, the sum of lam (nbar V once lam is normalized), sizes
    the list."""
    k_pois = split(make_key(seed))[0]
    return threefry_cuda.poisson_cells(k_pois, lam, expected=expected)


def cell_points(pm, cells, counts, ntot, seed):
    """(particle cell ids, f32 positions): each occupied cell repeated
    by its count, in raster order, at its corner plus the f32 uniform
    jitter ``uniform(split(key(seed))[1], (Ntot, 3))`` times the cell
    size."""
    cell_ids = torch.repeat_interleave(cells, counts, output_size=ntot)
    N0, N1, N2 = pm.shape_real
    H = torch.as_tensor(pm.cellsize, dtype=torch.float32, device=pm.device)
    idx = torch.stack([cell_ids // (N1 * N2), (cell_ids // N2) % N1,
                       cell_ids % N2], dim=-1)
    k_shift = split(make_key(seed))[1]
    jitter = uniform(k_shift, (ntot, 3), 'f4', device=pm.device)
    return cell_ids, idx.to(torch.float32) * H + jitter * H


def poisson_sample_to_points(delta, displacement, pm, nbar, bias=1.0,
                             seed=None):
    """Poisson-sample a (lognormal-transformed) density to particles.

    Steps (reference mockmaker.py:246-357): lognormal transform, per-cell
    Poisson counts, cell-corner positions + uniform in-cell jitter, and
    the Zel'dovich displacement of the particle's own cell.
    ``delta``'s buffer is reused for lam. Returns (pos, disp), f32 of
    shape (N, 3); N is data-dependent (one host sync).
    """
    if seed is None:
        seed = np.random.randint(0, 2 ** 31 - 1)
    lam = lognormal_lambda(delta.value, pm, nbar, bias)
    cells, counts, ntot = poisson_cells(
        lam, seed, expected=nbar * float(np.prod(pm.BoxSize)))
    del lam
    cell_ids, pos = cell_points(pm, cells, counts, ntot, seed)
    disp = None
    if displacement is not None:
        disp = torch.stack([d.value.reshape(-1)[cell_ids]
                            for d in displacement],
                           dim=-1).to(torch.float32)
    return pos, disp
