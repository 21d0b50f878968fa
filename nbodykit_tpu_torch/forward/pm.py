"""Symplectic kick-drift-kick PM stepper, a differentiable function of
the linear modes (counterpart of ``nbodykit_tpu/forward/pm.py``).

Einstein-de-Sitter gauge (Omega_m = 1, H0 = 1, box units), canonical
momentum p = a^2 dx/dt:

  dx/da = p * a^{-3/2}           (drift)
  dp/da = F(x) * a^{-1/2}        (kick)

F is the PM force, F_i(k) = 1.5 Omega_m * i k_i / k^2 * delta_k read
out at the particles. The KDK steps use the exact time integrals of the
prefactors over each interval:

  dkick(a0, a1)  = 2 (sqrt(a1) - sqrt(a0))
  ddrift(a0, a1) = 2 (1/sqrt(a0) - 1/sqrt(a1))

For matter + Lambda, ``E(a) = H(a)/H0`` turns them into
``int da / (a^2 E)`` and ``int da / (a^3 E)``, and the LPT initial
conditions take the growth factors of :class:`GrowthTable`.
``ForwardModel(omega_m=1)`` (the default) keeps the EdS closed forms.
"""

import numpy as np
import torch

from ..parallel.runtime import CurrentMesh, global_sum, mesh_size
from ..pmesh import ParticleMesh
from .lpt import _k_inv_k2, lpt_init, linear_amplitude, modes_from_white
from .adjoint import make_paint


def dkick(a0, a1):
    """Exact kick prefactor integral int_{a0}^{a1} a^{-1/2} da (EdS)."""
    return 2.0 * (np.sqrt(a1) - np.sqrt(a0))


def ddrift(a0, a1):
    """Exact drift prefactor integral int_{a0}^{a1} a^{-3/2} da (EdS)."""
    return 2.0 * (1.0 / np.sqrt(a0) - 1.0 / np.sqrt(a1))


# Gauss-Legendre nodes of the LCDM prefactor integrals (smooth
# integrands: 64 points are exact to machine precision)
_GL_X, _GL_W = np.polynomial.legendre.leggauss(64)


class GrowthTable:
    """Tabulated LCDM growth for the forward stepper: the first- and
    second-order growth of
    :class:`~nbodykit_tpu_torch.cosmology.background.MatterDominated`,
    solved once and rescaled to the early-time gauge ``D1(a) -> a``
    (EdS gives ``D1 = a``, ``D2 = -(3/7) a^2``). Every evaluation is a
    host float interpolated in ``log a``."""

    def __init__(self, omega_m, omega_k=0.0, na=8192):
        from ..cosmology.background import MatterDominated
        self.omega_m = float(omega_m)
        self.omega_k = float(omega_k)
        P = MatterDominated(self.omega_m, Omega0_k=self.omega_k)
        # the solver normalizes D1(1) = 1; the early-time limit
        # D1_raw(a) -> a restores the stepper's gauge
        a_ref = 1e-4
        scale = a_ref / float(P.D1(a_ref))
        self._P = P
        self._lna = np.log(np.geomspace(1e-3, 1.5, int(na)))
        a = np.exp(self._lna)
        self._D1 = np.asarray(P.D1(a), dtype='f8') * scale
        self._f1 = np.asarray(P.f1(a), dtype='f8')
        self._D2 = np.asarray(P.D2(a), dtype='f8') * scale ** 2
        self._f2 = np.asarray(P.f2(a), dtype='f8')

    def _interp(self, tab, a):
        out = np.interp(np.log(np.asarray(a, dtype='f8')),
                        self._lna, tab)
        return float(out) if np.ndim(a) == 0 else out

    def D1(self, a):
        """First-order growth factor (early-time gauge D1 -> a)."""
        return self._interp(self._D1, a)

    def f1(self, a):
        """First-order growth rate dlnD1/dlna."""
        return self._interp(self._f1, a)

    def D2(self, a):
        """Second-order growth factor (EdS limit -(3/7) a^2)."""
        return self._interp(self._D2, a)

    def f2(self, a):
        """Second-order growth rate dlnD2/dlna."""
        return self._interp(self._f2, a)

    def E(self, a):
        """Dimensionless Hubble rate H(a)/H0."""
        out = self._P.efunc(a)
        return float(out) if np.ndim(a) == 0 else out

    def _quad(self, f, a0, a1):
        mid, half = 0.5 * (a0 + a1), 0.5 * (a1 - a0)
        a = mid + half * _GL_X
        return float(np.sum(_GL_W * f(a)) * half)

    def dkick(self, a0, a1):
        """Kick prefactor integral int_{a0}^{a1} da / (a^2 E(a))."""
        return self._quad(lambda a: 1.0 / (a * a * self.E(a)), a0, a1)

    def ddrift(self, a0, a1):
        """Drift prefactor integral int_{a0}^{a1} da / (a^3 E(a))."""
        return self._quad(lambda a: 1.0 / (a ** 3 * self.E(a)),
                          a0, a1)


def power_law(A=1.0, n=-2.5):
    """A pure power-law linear spectrum P(k) = A k^n (box units)."""
    def P(k):
        return A * k ** n
    return P


def normalized_amplitude(pm, n=-2.5, delta_rms=1.0):
    """:func:`~.lpt.linear_amplitude` of a power law, rescaled so the
    linear field at a = 1 has real-space rms ``delta_rms`` on this mesh
    (Var[delta(x)] = sum_k P(k)/V over the hermitian-weighted
    compressed modes)."""
    amp = linear_amplitude(pm, power_law(1.0, n))
    w = torch.full(pm.local_shape_complex, 2.0, dtype=amp.dtype,
                   device=amp.device)
    w[..., 0] = 1.0
    if int(pm.Nmesh[2]) % 2 == 0:
        w[..., -1] = 1.0
    var = global_sum(w * amp * amp, pm.comm)
    return amp * (delta_rms / torch.sqrt(var))


class ForwardModel:
    """LPT initial conditions + KDK PM evolution + paint, as one
    differentiable map of the linear modes.

    nmesh : force mesh cells a side; npart : particles, a cube ng^3
    (default nmesh^3); pm_steps : KDK steps from ``a_start`` to
    ``a_end``; order : 1 (ZA) or 2 (2LPT); linear_power : P(k)
    callable (default a power law of ``spectral_index`` normalized to
    ``delta_rms``); dtype : mesh dtype; comm : the mesh of P ranks
    (default: the ambient one); ng and nmesh must be divisible by P;
    device : 'cuda' or 'cpu' (default: the comm's device, else the
    ``device`` option, else 'cuda').

    The model owns ``lattice`` (ng^3: the linear modes and the
    inference leaf) and ``pm`` (nmesh^3: forces and the painted
    density). With P ranks both are slab meshes on the comm: the modes
    and the leaf are this rank's slabs, the particles start from this
    rank's rows of the lattice (its x-slab), and the paints, transforms
    and readouts run across the ranks, differentiable end to end.
    """

    def __init__(self, nmesh, npart=None, BoxSize=1000.0, pm_steps=5,
                 a_start=0.1, a_end=1.0, order=2, resampler='cic',
                 linear_power=None, spectral_index=-2.5, delta_rms=1.0,
                 omega_m=1.0, dtype='f8', comm=None, device=None):
        if npart is None:
            npart = int(nmesh) ** 3
        ng = int(round(float(npart) ** (1.0 / 3.0)))
        if ng ** 3 != int(npart):
            raise ValueError("npart=%d is not a cube; the particle "
                             "lattice needs ng^3" % npart)
        if int(pm_steps) < 1:
            raise ValueError("pm_steps must be >= 1")
        nproc = mesh_size(CurrentMesh.resolve(comm))
        for what, n in (('ng (npart = ng^3)', ng), ('nmesh', int(nmesh))):
            if n % nproc:
                raise ValueError("ForwardModel across %d ranks needs %s "
                                 "divisible by the rank count, got %d"
                                 % (nproc, what, n))
        self.pm = ParticleMesh(nmesh, BoxSize, dtype, device=device,
                               comm=comm)
        self.lattice = self.pm if ng == int(self.pm.Nmesh[0]) \
            else ParticleMesh(ng, BoxSize, dtype, device=self.pm.device,
                              comm=self.pm.comm)
        self.device = self.pm.device
        self.npart = int(npart)
        self.pm_steps = int(pm_steps)
        self.a_start = float(a_start)
        self.a_end = float(a_end)
        self.order = int(order)
        self.resampler = resampler
        self.omega_m = float(omega_m)
        # omega_m != 1 takes the tabulated LCDM growth; the EdS default
        # keeps the closed-form prefactors
        self.growth = None if self.omega_m == 1.0 \
            else GrowthTable(self.omega_m)
        self.paint_fn, self.paint_cfg = make_paint(
            self.pm, self.npart, resampler)
        if linear_power is not None:
            self.amp = linear_amplitude(self.lattice, linear_power)
        else:
            self.amp = normalized_amplitude(
                self.lattice, spectral_index, delta_rms)

    # -- parametrizations -------------------------------------------------

    def linear_modes(self, seed):
        """Truth linear modes for ``seed`` (JAX's draw)."""
        return self.lattice.generate_whitenoise(seed) * self.amp

    def white_guess(self):
        """The zero real whitenoise leaf inference starts from (this
        rank's slab)."""
        return torch.zeros(self.lattice.local_shape_real,
                           dtype=self.lattice.torch_compute_dtype,
                           device=self.device)

    def modes_from_white(self, white):
        """Differentiable real-leaf -> linear-modes map (lpt.py)."""
        return modes_from_white(self.lattice, white, self.amp)

    # -- dynamics ---------------------------------------------------------

    def gravity(self, pos):
        """PM force at ``pos``: paint -> k-space Poisson -> readout x3
        (one routing across ranks); (npart, 3) box-unit
        accelerations."""
        pm = self.pm
        rho = self.paint_fn(pos)
        nbar = self.npart / pm.Ntot
        delta_k = pm.r2c(rho.to(pm.torch_compute_dtype) / nbar - 1.0)
        kv, inv = _k_inv_k2(pm)
        acc = pm.readout_many(
            [pm.c2r(1.5 * self.omega_m * 1j * kv[d] * inv * delta_k)
             for d in range(3)], pos, resampler=self.resampler)
        return torch.stack(acc, dim=-1)

    def _dkick(self, a0, a1):
        return dkick(a0, a1) if self.growth is None \
            else self.growth.dkick(a0, a1)

    def _ddrift(self, a0, a1):
        return ddrift(a0, a1) if self.growth is None \
            else self.growth.ddrift(a0, a1)

    def kdk_step(self, pos, mom, a0, a1):
        """One kick-drift-kick step from a0 to a1 (the kick split at the
        geometric midpoint)."""
        ah = np.sqrt(a0 * a1)
        mom = mom + self.gravity(pos) * self._dkick(a0, ah)
        pos = pos + mom * self._ddrift(a0, a1)
        mom = mom + self.gravity(pos) * self._dkick(ah, a1)
        return pos, mom

    def evolve(self, modes):
        """Linear modes -> (positions, momenta) at ``a_end``: LPT at
        ``a_start``, then ``pm_steps`` KDK steps."""
        pos, mom = lpt_init(self.lattice, modes, a=self.a_start,
                            order=self.order, growth=self.growth)
        aa = np.linspace(self.a_start, self.a_end, self.pm_steps + 1)
        for a0, a1 in zip(aa[:-1], aa[1:]):
            pos, mom = self.kdk_step(pos, mom, float(a0), float(a1))
        return pos, mom

    def density(self, modes):
        """The observable: the evolved particles painted on the force
        mesh, normalized to 1 + delta."""
        pos, _ = self.evolve(modes)
        rho = self.paint_fn(pos)
        return rho.to(self.pm.torch_compute_dtype) \
            * (self.pm.Ntot / self.npart)
