"""Linear Einstein-Boltzmann engine (a copy of
``nbodykit_tpu/cosmology/boltzmann.py``, numpy and scipy only).

- **Background**: exact massive-neutrino (ncdm) energy density and
  pressure from Fermi-Dirac momentum integrals (Gauss-Laguerre), photon
  + ultra-relativistic species, CPL dark energy, curvature; conformal
  time tables.
- **Thermodynamics**: Saha helium + effective three-level (Peebles /
  RECFAST-style) hydrogen recombination with Compton-coupled baryon
  temperature, tanh reionization, Thomson opacity, sound horizon,
  recombination / drag redshifts.
- **Perturbations** (``BoltzmannSolver``): the conformal-Newtonian-gauge
  Einstein-Boltzmann hierarchy of Ma & Bertschinger (1995), per k-mode,
  with tight coupling, a radiation-streaming approximation and an ncdm
  fluid after it. ``solve_mode`` runs the native kernel (the root
  ``csrc/boltzmann_kernel.cpp``, built with g++ by
  :func:`nbodykit_tpu_torch._build.build_host`); ``use_native=False``
  selects the scipy BDF path instead. A failed build or a failed native
  solve raises: nothing falls back.
- **Engine** (``BoltzmannEngine``): the k grid, P(k, z), sigma8 and the
  CLASS-format transfer dictionary. Tables are looked up first among the
  shipped ones (``cosmology/data/<key>.npz``, the five built-in
  parameter sets), then in the user cache (``$NBKIT_TORCH_CLASS_CACHE``,
  default ``~/.cache/nbodykit_tpu_torch/boltzmann``), else solved and
  written there.

Outputs: matter transfer functions ``T_i(k, z)`` for unit primordial
curvature, the linear matter power spectrum

    P(k, z) = 2 pi^2 / k^3 * A_s (k/k_pivot)^(n_s-1) * T_m(k,z)^2,

sigma8, and a CLASS-format ``get_transfer`` dictionary.

Approximations vs CLASS (all sub-percent for LCDM-like parameters at
k <= 10 h/Mpc): no dark-energy perturbations for the fld component;
curvature enters the background only; the ncdm fluid approximation
after the RSA switch uses the adiabatic sound speed with freely-decaying
anisotropic stress.
"""

import os
import hashlib
import numpy as np
from scipy import integrate, interpolate

# ---------------------------------------------------------------------------
# constants

H0_MPC = 1.0 / 2997.92458       # (H0/h) in 1/Mpc  (100 km/s/Mpc over c)
EV_OVER_K = 11604.51812         # Kelvin per eV
KB_EV = 1.0 / EV_OVER_K         # eV per Kelvin
SIGMA_T_CM2 = 6.6524587321e-25  # Thomson cross-section, cm^2
MPC_CM = 3.0856775814913673e24  # Mpc in cm
RHO_CRIT_CGS = 1.878341616e-29  # critical density / h^2, g/cm^3
M_H_G = 1.673575e-24            # hydrogen atom mass, g
M_E_EV = 510998.95              # electron mass, eV
# (2 pi m_e k_B / h^2)^(3/2) * T^(3/2) in cm^-3 with T in K
SAHA_PREF = 2.4146817e15
# Compton heating rate prefactor: 8 sigma_T a_R / (3 m_e c), in
# s^-1 K^-4 (multiplies T_gamma^4): 8*6.6524e-25*7.5657e-15/(3*9.109e-28*2.998e10)
COMPTON_PREF = 4.91466895e-22
SEC_PER_MPC = MPC_CM / 2.99792458e10   # light-crossing time of 1 Mpc, s

ION_H_EV = 13.598434            # hydrogen ionization energy
ION_HE1_EV = 24.587389          # He I first ionization
ION_HE2_EV = 54.417765          # He II (-> He III)
LYA_EV = ION_H_EV * 0.75        # Lyman-alpha energy (10.1988 eV)
LAMBDA_2S1S = 8.2245809         # H 2s->1s two-photon rate, 1/s
LYA_CM = 1.21567e-5             # Lyman-alpha wavelength, cm

T_NCDM_RATIO = 0.71611          # CLASS convention: T_ncdm / T_cmb
K_PIVOT_MPC = 0.05              # primordial pivot, 1/Mpc


def _fermi_dirac_quadrature(n):
    """Nodes/weights for integrals  int_0^inf dq q^2 f0(q) g(q)  with
    f0 = 1/(e^q + 1): Gauss-Laguerre re-weighted."""
    x, w = np.polynomial.laguerre.laggauss(n)
    W = w * np.exp(x) * x * x / (np.exp(x) + 1.0)
    return x, W


class NcdmSpecies(object):
    """One massive neutrino species: background momentum integrals.

    rho(a)/rho_crit0 = Omega_g0 * (7/8) Tr^4 * a^-4 * F(y)/F(0),
    y = a m / (k_B T_ncdm0); F, G are the energy / pressure integrals.
    """

    def __init__(self, m_ev, T_cmb_K, Omega_g, deg=1.0):
        self.m_ev = float(m_ev)
        self.deg = float(deg)
        self.T_ncdm0_K = T_NCDM_RATIO * T_cmb_K
        self.T_ncdm0_ev = self.T_ncdm0_K * KB_EV
        # y(a) = a * m / T0  (momentum q measured in units of T_ncdm0/a)
        self.y0 = self.m_ev / self.T_ncdm0_ev
        q, W = _fermi_dirac_quadrature(24)
        self._q, self._W = q, W
        self._F0 = np.sum(W * q)            # = 7 pi^4 / 120
        self._rel_density = deg * (7.0 / 8) * T_NCDM_RATIO ** 4 * Omega_g

    def y(self, a):
        return np.asarray(a, dtype='f8') * self.y0

    def rho_over_rhocrit0(self, a):
        """rho_ncdm(a) / rho_crit0 (exact momentum integral)."""
        a = np.asarray(a, dtype='f8')
        y = self.y(a)[..., None]
        F = np.sum(self._W * np.sqrt(self._q ** 2 + y ** 2), axis=-1)
        return self._rel_density * F / self._F0 / a ** 4

    def p_over_rhocrit0(self, a):
        a = np.asarray(a, dtype='f8')
        y = self.y(a)[..., None]
        G = np.sum(self._W * self._q ** 2
                   / np.sqrt(self._q ** 2 + y ** 2), axis=-1) / 3.0
        return self._rel_density * G / self._F0 / a ** 4


class Background(object):
    """Homogeneous background: E(a), conformal time, exact ncdm.

    Parameters are plain floats (the Cosmology class adapts its
    parameter bag into this).  Internal units: lengths in Mpc (no h).
    """

    def __init__(self, h, T0_cmb, Omega_b, Omega_cdm, Omega_k=0.0,
                 N_ur=3.046, m_ncdm=(), w0_fld=-1.0, wa_fld=0.0,
                 use_fld=False, Omega_lambda=None, Omega_fld=None):
        self.h = float(h)
        self.T0_cmb = float(T0_cmb)
        self.H0 = h * H0_MPC                          # 1/Mpc
        self.Omega_g = 2.47282e-5 * (T0_cmb / 2.7255) ** 4 / h ** 2
        self.Omega_ur = N_ur * (7.0 / 8) * (4.0 / 11) ** (4.0 / 3) \
            * self.Omega_g
        self.Omega_b = float(Omega_b)
        self.Omega_cdm = float(Omega_cdm)
        self.Omega_k = float(Omega_k)
        self.w0_fld = float(w0_fld)
        self.wa_fld = float(wa_fld)
        self.ncdm = [NcdmSpecies(m, T0_cmb, self.Omega_g)
                     for m in m_ncdm if m]
        self.Omega_ncdm = float(sum(s.rho_over_rhocrit0(1.0)
                                    for s in self.ncdm))
        budget = 1.0 - self.Omega_k - self.Omega_g - self.Omega_ur \
            - self.Omega_b - self.Omega_cdm - self.Omega_ncdm
        if Omega_lambda is None and Omega_fld is None:
            # closure: all dark energy in one component
            if use_fld:
                self.Omega_lambda, self.Omega_fld = 0.0, budget
            else:
                self.Omega_lambda, self.Omega_fld = budget, 0.0
        else:
            self.Omega_lambda = float(Omega_lambda or 0.0)
            self.Omega_fld = float(Omega_fld or 0.0)
        self.use_fld = bool(use_fld or self.Omega_fld != 0.0)
        self.Omega_de = self.Omega_lambda + self.Omega_fld
        self._tau_spl = None
        self._a_of_tau = None

    # -- densities (all as rho/rho_crit0) -----------------------------------

    def de_factor(self, a):
        """rho_fld(a)/rho_fld(0) for CPL."""
        a = np.asarray(a, dtype='f8')
        if not self.use_fld:
            return np.ones_like(a)
        w0, wa = self.w0_fld, self.wa_fld
        return a ** (-3 * (1 + w0 + wa)) * np.exp(-3 * wa * (1 - a))

    def E2(self, a):
        a = np.asarray(a, dtype='f8')
        E2 = (self.Omega_g + self.Omega_ur) / a ** 4 \
            + (self.Omega_b + self.Omega_cdm) / a ** 3 \
            + self.Omega_k / a ** 2 \
            + self.Omega_lambda + self.Omega_fld * self.de_factor(a)
        for s in self.ncdm:
            E2 = E2 + s.rho_over_rhocrit0(a)
        return E2

    def H_conformal(self, a):
        """curly-H = a H(a), in 1/Mpc."""
        return np.asarray(a) * self.H0 * np.sqrt(self.E2(a))

    def _build_tau(self):
        lna = np.linspace(np.log(1e-10), np.log(2.0), 4096)
        a = np.exp(lna)
        # d tau / d lna = 1 / (a H) ; seed with the radiation-era value
        inv_aH = 1.0 / self.H_conformal(a)
        tau0 = a[0] / (self.H0 * np.sqrt(
            self.Omega_g + self.Omega_ur
            + sum(s._rel_density for s in self.ncdm)))
        tau = tau0 + integrate.cumulative_trapezoid(inv_aH, lna, initial=0.0)
        self._tau_spl = interpolate.InterpolatedUnivariateSpline(
            lna, np.log(tau), k=3)
        self._a_of_tau = interpolate.InterpolatedUnivariateSpline(
            np.log(tau), lna, k=3)

    def tau(self, a):
        """Conformal time in Mpc."""
        if self._tau_spl is None:
            self._build_tau()
        return np.exp(self._tau_spl(np.log(np.asarray(a, dtype='f8'))))

    def a_of_tau(self, tau):
        if self._a_of_tau is None:
            self._build_tau()
        return np.exp(self._a_of_tau(np.log(np.asarray(tau, dtype='f8'))))


class Thermodynamics(object):
    """Recombination + reionization history and derived epochs."""

    def __init__(self, bg, YHe=0.2454, z_reio=11.357, reio_width=0.5,
                 fudge=1.14):
        self.bg = bg
        self.YHe = float(YHe)
        self.z_reio = float(z_reio)
        self.reio_width = float(reio_width)
        self.fudge = float(fudge)
        # number densities today (cm^-3)
        omega_b = bg.Omega_b * bg.h ** 2
        self.n_H0 = (1.0 - YHe) * omega_b * RHO_CRIT_CGS / M_H_G
        self.f_He = YHe / (4.0 * (1.0 - YHe))   # n_He / n_H
        self._solve()

    # -- Saha phases --------------------------------------------------------

    def _saha_xe(self, z, Tg):
        """Full Saha equilibrium x_e = n_e/n_H (H + He I + He II)."""
        n_H = self.n_H0 * (1 + z) ** 3
        S = SAHA_PREF * Tg ** 1.5 / n_H     # (2 pi me k T/h^2)^(3/2)/n_H
        rH = S * np.exp(-ION_H_EV * EV_OVER_K / Tg)          # np ne/n1s /nH
        rHe1 = 4.0 * S * np.exp(-ION_HE1_EV * EV_OVER_K / Tg)
        rHe2 = S * np.exp(-ION_HE2_EV * EV_OVER_K / Tg)
        xe = 1.0 + 2 * self.f_He
        for _ in range(60):
            xH = rH / (rH + xe)
            d1 = rHe1 / xe
            d2 = rHe2 / xe
            xHe2 = d1 / (1.0 + d1 + d1 * d2)    # singly ionized fraction
            xHe3 = d1 * d2 / (1.0 + d1 + d1 * d2)
            xe_new = xH + self.f_He * (xHe2 + 2 * xHe3)
            if abs(xe_new - xe) < 1e-12:
                xe = xe_new
                break
            xe = 0.5 * (xe + xe_new)
        return max(xe, 1e-12), xH

    # -- the main solve -----------------------------------------------------

    def _solve(self):
        bg = self.bg

        def Hz(z):        # H(z) in 1/s
            a = 1.0 / (1 + z)
            return bg.H0 * np.sqrt(bg.E2(a)) / SEC_PER_MPC

        # Peebles/RECFAST hydrogen ODE, x = [x_H, T_m]
        def rhs(z, y):
            xH = min(max(y[0], 0.0), 1.0)
            Tm = max(y[1], 1e-4)
            Tg = bg.T0_cmb * (1 + z)
            n_H = self.n_H0 * (1 + z) ** 3
            # helium stays Saha (already ~neutral in the ODE range)
            xe_He = self._saha_He_only(z, Tg)
            xe = xH + xe_He
            H = Hz(z)
            T4 = Tm / 1e4
            alpha = self.fudge * 4.309e-13 * T4 ** -0.6166 \
                / (1 + 0.6703 * T4 ** 0.5300)               # cm^3/s
            beta = alpha * SAHA_PREF * Tm ** 1.5 \
                * np.exp(-0.25 * ION_H_EV * EV_OVER_K / Tm)  # 1/s
            # Peebles C factor
            n_1s = (1.0 - xH) * n_H
            K = LYA_CM ** 3 / (8 * np.pi * H)
            C = (1.0 + K * LAMBDA_2S1S * n_1s) \
                / (1.0 + K * (LAMBDA_2S1S + beta) * n_1s)
            dxH = C * (xe * xH * n_H * alpha
                       - beta * (1 - xH)
                       * np.exp(-LYA_EV * EV_OVER_K / Tm)) / (H * (1 + z))
            # matter temperature: Compton + adiabatic
            comp = COMPTON_PREF * Tg ** 4 * xe / (1 + self.f_He + xe)
            dTm = comp * (Tm - Tg) / (H * (1 + z)) + 2 * Tm / (1 + z)
            return [dxH, dTm]

        # start where Saha still holds for H
        z_start = 1680.0
        Tg_start = bg.T0_cmb * (1 + z_start)
        _, xH0 = self._saha_xe(z_start, Tg_start)
        sol = integrate.solve_ivp(
            rhs, (z_start, 0.0), [min(xH0, 1.0 - 1e-8), Tg_start],
            method='LSODA', rtol=1e-8, atol=[1e-12, 1e-6], dense_output=True)

        # assemble x_e(z) on a dense grid: Saha above z_start, ODE below
        z_hi = np.linspace(9999.0, z_start, 600)
        xe_hi = np.array([self._saha_xe(z, bg.T0_cmb * (1 + z))[0]
                          for z in z_hi])
        z_lo = np.linspace(z_start, 0.0, 3500)
        ysol = sol.sol(z_lo)
        xH_lo = np.clip(ysol[0], 1e-12, 1.0)
        xe_lo = xH_lo + np.array([
            self._saha_He_only(z, bg.T0_cmb * (1 + z)) for z in z_lo])
        Tm_lo = ysol[1]

        z_all = np.concatenate([z_hi, z_lo[1:]])
        xe_all = np.concatenate([xe_hi, xe_lo[1:]])
        Tm_all = np.concatenate([bg.T0_cmb * (1 + z_hi), Tm_lo[1:]])

        # reionization (tanh in (1+z)^1.5, CAMB-style) + He reionization
        xe_all = self._add_reio(z_all, xe_all)

        z_rev = z_all[::-1]          # increasing z
        self._z_grid = z_rev
        self._xe_spl = interpolate.InterpolatedUnivariateSpline(
            z_rev, xe_all[::-1], k=3)
        self._Tm_spl = interpolate.InterpolatedUnivariateSpline(
            z_rev, Tm_all[::-1], k=3)

        # Thomson opacity dkappa/dtau(a) in 1/Mpc
        def dkappa(z):
            ne = self.xe(z) * self.n_H0 * (1 + z) ** 3
            return ne * SIGMA_T_CM2 * MPC_CM / (1 + z)

        self.dkappa_of_z = dkappa

        # optical depth kappa(z) = int_0^z dkappa/dtau * dtau/dz dz
        a_rev = 1.0 / (1 + z_rev)
        dtau_dz = 1.0 / (bg.H_conformal(a_rev) * (1 + z_rev))
        integ = dkappa(z_rev) * dtau_dz
        kappa = integrate.cumulative_trapezoid(integ, z_rev, initial=0.0)
        self._kappa_spl = interpolate.InterpolatedUnivariateSpline(
            z_rev, kappa, k=3)
        # visibility peak = recombination
        g = dkappa(z_rev) * np.exp(-kappa) * dtau_dz
        mask = (z_rev > 600) & (z_rev < 1600)
        self.z_rec = float(z_rev[mask][np.argmax(g[mask])])
        self.tau_reio = float(self._kappa_spl(min(self.z_reio + 15, 150.0)))

        # drag epoch: kappa_drag = int dkappa / R, R = 3 rho_b/(4 rho_g)
        R = 3.0 * bg.Omega_b * a_rev / (4.0 * bg.Omega_g)
        integ_d = integ / R
        kappa_d = integrate.cumulative_trapezoid(integ_d, z_rev, initial=0.0)
        i = np.searchsorted(kappa_d, 1.0)
        i = min(max(i, 1), len(z_rev) - 1)
        # linear inversion for kappa_d = 1
        z0, z1 = z_rev[i - 1], z_rev[i]
        k0, k1 = kappa_d[i - 1], kappa_d[i]
        self.z_drag = float(z0 + (1.0 - k0) * (z1 - z0) / (k1 - k0))

        # sound horizon r_s(z) = int_z^inf cs dtau
        cs = 1.0 / np.sqrt(3.0 * (1.0 + R))
        # integrate from high z down: r_s(z) = int_0^{a(z)} cs/(a H a) da;
        # do it on the grid (z decreasing from 9999)
        # integrate downward from z_max so rs[i] = int_{z_i}^{zmax}
        rs = integrate.cumulative_trapezoid(
            (cs * dtau_dz)[::-1], z_rev[::-1], initial=0.0)[::-1] * -1.0
        # add the contribution above z=9999 (radiation era, R->0)
        a_top = 1.0 / (1 + z_rev[-1])
        rs += bg.tau(a_top) / np.sqrt(3.0)
        self._rs_spl = interpolate.InterpolatedUnivariateSpline(
            z_rev, rs, k=3)
        self.rs_drag = float(self._rs_spl(self.z_drag))
        self.rs_rec = float(self._rs_spl(self.z_rec))

    def _saha_He_only(self, z, Tg):
        """He contribution to x_e when H is handled by the ODE (z<1700):
        only single ionization matters and it is tiny; Saha."""
        n_H = self.n_H0 * (1 + z) ** 3
        S = SAHA_PREF * Tg ** 1.5 / n_H
        r = 4.0 * S * np.exp(-ION_HE1_EV * EV_OVER_K / Tg)
        # n_HeII/n_HeI = r / x_e ; with x_e ~ 1: fraction r/(1+r)
        frac = r / (1.0 + r)
        return self.f_He * frac

    def _add_reio(self, z, xe):
        xe_max = 1.0 + self.f_He
        y = (1 + z) ** 1.5
        yre = (1 + self.z_reio) ** 1.5
        dy = 1.5 * np.sqrt(1 + self.z_reio) * self.reio_width
        frac = 0.5 * (1 + np.tanh((yre - y) / dy))
        out = xe + frac * np.maximum(xe_max - xe, 0.0)
        # helium second reionization at z ~ 3.5
        frac_He = 0.5 * (1 + np.tanh((3.5 - z) / 0.5))
        return out + frac_He * self.f_He

    # -- queries ------------------------------------------------------------

    _z_grid_max = 9900.0

    def xe(self, z):
        """x_e(z); above the solved grid the plasma is fully ionized."""
        z = np.asarray(z, dtype='f8')
        hi = 1.0 + 2.0 * self.f_He
        return np.where(z > self._z_grid_max, hi,
                        np.clip(self._xe_spl(np.minimum(z,
                                                        self._z_grid_max)),
                                1e-12, None))

    def Tb(self, z):
        """Baryon temperature; locked to T_gamma above the grid."""
        z = np.asarray(z, dtype='f8')
        return np.where(z > self._z_grid_max,
                        self.bg.T0_cmb * (1.0 + z),
                        self._Tm_spl(np.minimum(z, self._z_grid_max)))

    def kappa(self, z):
        return self._kappa_spl(np.asarray(z, dtype='f8'))

    def dkappa(self, a):
        """dkappa/dtau at scale factor a, 1/Mpc."""
        return self.dkappa_of_z(1.0 / np.asarray(a, dtype='f8') - 1.0)

    def cs2_b(self, a):
        """Baryon sound speed squared (units of c^2):
        cs^2 = (k_B T_b / mu c^2) (1 - dlnT_b/dlna / 3)."""
        a = np.asarray(a, dtype='f8')
        z = 1.0 / a - 1.0
        Tb = np.maximum(self.Tb(z), 1e-4)
        # dlnT/dlna = -(1+z) dT/dz / T; = -1 when locked to T_gamma
        dlnT = np.where(
            z > self._z_grid_max, -1.0,
            self._Tm_spl.derivative()(np.minimum(z, self._z_grid_max))
            * (-(1 + z)) / Tb)
        mu_inv = (1.0 + self.f_He + self.xe(z)) / (1.0 + 4.0 * self.f_He)
        M_H_EV = 938.783e6
        return np.maximum(
            KB_EV * Tb / M_H_EV * mu_inv
            * (1.0 - np.clip(dlnT, -3.0, 3.0) / 3.0), 0.0)


class BoltzmannSolver(object):
    """Per-k integration of the linear Einstein-Boltzmann system.

    Equations: Ma & Bertschinger (1995), conformal Newtonian gauge.
    State (full phase): [phi, d_c, t_c, d_b, t_b,
                         F_g[0..lg], G_g[0..lp], F_ur[0..lu],
                         Psi[q, 0..ln] per ncdm species].
    After the RSA switch (k tau > rsa_ktau and Thomson scattering
    negligible) photons/ur are slaved to the metric and ncdm collapses
    to a fluid, leaving a 5(+3/species) dim system.
    """

    def __init__(self, bg, th, lmax_g=10, lmax_pol=8, lmax_ur=12,
                 nq_ncdm=4, lmax_ncdm=5, rsa_ktau=45.0, rsa_dkappa_tau=0.06,
                 rtol=3e-6, use_native=True):
        self.use_native = bool(use_native)
        self.bg = bg
        self.th = th
        self.lg, self.lp, self.lu, self.ln = lmax_g, lmax_pol, lmax_ur, \
            lmax_ncdm
        self.nq = nq_ncdm
        self.rsa_ktau = rsa_ktau
        self.rsa_dkappa_tau = rsa_dkappa_tau
        self.rtol = rtol

        q, W = _fermi_dirac_quadrature(nq_ncdm)
        self._q, self._Wq = q, W
        self._dlnf = -q / (1.0 + np.exp(-q))      # dln f0 / dln q

        n = 5 + (lmax_g + 1) + (lmax_pol + 1) + (lmax_ur + 1) \
            + len(bg.ncdm) * nq_ncdm * (lmax_ncdm + 1)
        self.nvar = n
        self._iFg = 5
        self._iGg = self._iFg + lmax_g + 1
        self._iFu = self._iGg + lmax_pol + 1
        self._incdm = self._iFu + lmax_ur + 1

        # hierarchy coefficient tables
        l = np.arange(0, max(lmax_g, lmax_pol, lmax_ur, lmax_ncdm) + 1,
                      dtype='f8')
        self._l = l

        # background tables on a uniform lna grid for O(1) lookups in
        # the RHS (scipy spline __call__ overhead dominates otherwise)
        NG = 16384
        self._gx0 = np.log(1e-10)
        self._gx1 = np.log(1.01)
        self._gdx = (self._gx1 - self._gx0) / (NG - 1)
        lna = np.linspace(self._gx0, self._gx1, NG)
        a = np.exp(lna)
        self._g_lnHc = np.log(bg.H_conformal(a))
        self._g_lntau = np.log(bg.tau(a))
        with np.errstate(divide='ignore'):
            dk = th.dkappa(a)
        self._g_lndk = np.log(np.maximum(dk, 1e-300))
        self._g_cs2 = np.maximum(th.cs2_b(a), 0.0)
        # spline-compatible views used by non-hot-path helpers
        mk = lambda vals: interpolate.InterpolatedUnivariateSpline(
            lna[::8], vals[::8], k=3)
        self._spl_Hc = mk(self._g_lnHc)
        self._spl_tau = mk(self._g_lntau)
        self._spl_dkappa = mk(self._g_lndk)
        self._spl_cs2 = interpolate.InterpolatedUnivariateSpline(
            lna[::8], self._g_cs2[::8], k=1)

        H02 = bg.H0 ** 2
        self._drho_g = lambda a: H02 * bg.Omega_g / a ** 2
        self._drho_ur = lambda a: H02 * bg.Omega_ur / a ** 2
        self._drho_b = lambda a: H02 * bg.Omega_b / a
        self._drho_c = lambda a: H02 * bg.Omega_cdm / a

        # ncdm: drho(a), w(a), adiabatic sound speed tables
        self._g_ncdm_lndrho = []
        self._g_ncdm_w = []
        self._g_ncdm_cg2 = []
        self._ncdm_drho = []
        self._ncdm_w = []
        self._ncdm_cg2 = []
        for s in bg.ncdm:
            rho = s.rho_over_rhocrit0(a)
            p = s.p_over_rhocrit0(a)
            w = p / rho
            lndr = np.log(H02 * rho * a ** 2)
            wspl = interpolate.InterpolatedUnivariateSpline(
                lna[::8], w[::8], k=3)
            cg2 = np.clip(w - wspl.derivative()(lna)
                          / (3.0 * (1.0 + w)), 0.0, 1.0 / 3)
            self._g_ncdm_lndrho.append(lndr)
            self._g_ncdm_w.append(w)
            self._g_ncdm_cg2.append(cg2)
            dr = interpolate.InterpolatedUnivariateSpline(
                lna[::8], lndr[::8], k=3)
            self._ncdm_drho.append(lambda x, _d=dr: np.exp(_d(x)))
            self._ncdm_w.append(wspl)
            self._ncdm_cg2.append(
                interpolate.InterpolatedUnivariateSpline(
                    lna[::8], cg2[::8], k=1))

    def _lookup(self, x):
        """Uniform-grid linear interpolation of the background tables:
        returns (Hc, tau, dkappa, cs2, frac_index)."""
        t = (x - self._gx0) / self._gdx
        if t < 0.0:
            t = 0.0
        n2 = len(self._g_lnHc) - 2
        if t > n2:
            t = float(n2)
        i = int(t)
        f = t - i
        lnHc = self._g_lnHc[i] + (self._g_lnHc[i + 1]
                                  - self._g_lnHc[i]) * f
        lntau = self._g_lntau[i] + (self._g_lntau[i + 1]
                                    - self._g_lntau[i]) * f
        lndk = self._g_lndk[i] + (self._g_lndk[i + 1]
                                  - self._g_lndk[i]) * f
        cs2 = self._g_cs2[i] + (self._g_cs2[i + 1] - self._g_cs2[i]) * f
        return np.exp(lnHc), np.exp(lntau), np.exp(lndk), cs2, (i, f)

    def _lookup_ncdm(self, idx, i, f):
        ldr = self._g_ncdm_lndrho[idx]
        wt = self._g_ncdm_w[idx]
        cg = self._g_ncdm_cg2[idx]
        return (np.exp(ldr[i] + (ldr[i + 1] - ldr[i]) * f),
                wt[i] + (wt[i + 1] - wt[i]) * f,
                cg[i] + (cg[i + 1] - cg[i]) * f)

    # -- initial conditions -------------------------------------------------

    def _initial(self, k, lna0):
        bg = self.bg
        a0 = np.exp(lna0)
        tau0 = float(np.exp(self._spl_tau(lna0)))
        # radiation fraction in relativistic species
        rho_g = bg.Omega_g / a0 ** 4
        rho_ur = bg.Omega_ur / a0 ** 4
        rho_nu_rel = sum(s.rho_over_rhocrit0(a0) for s in bg.ncdm)
        R_nu = (rho_ur + rho_nu_rel) / (rho_g + rho_ur + rho_nu_rel)

        psi = 10.0 / (15.0 + 4.0 * R_nu)          # curvature R = 1
        phi = (1.0 + 2.0 * R_nu / 5.0) * psi
        kt = k * tau0
        dg = -2.0 * psi
        th_com = 0.5 * k * kt * psi               # k^2 tau psi / 2
        sig_nu = kt ** 2 * psi / 15.0

        y = np.zeros(self.nvar)
        y[0] = phi
        y[1] = 0.75 * dg
        y[2] = th_com
        y[3] = 0.75 * dg
        y[4] = th_com
        y[self._iFg + 0] = dg
        y[self._iFg + 1] = 4.0 * th_com / (3.0 * k)
        y[self._iFu + 0] = dg
        y[self._iFu + 1] = 4.0 * th_com / (3.0 * k)
        y[self._iFu + 2] = 2.0 * sig_nu
        off = self._incdm
        for s in bg.ncdm:
            eps = np.sqrt(self._q ** 2 + s.y(a0) ** 2)
            for iq in range(self.nq):
                base = off + iq * (self.ln + 1)
                dl = self._dlnf[iq]
                y[base + 0] = -0.25 * dg * dl
                y[base + 1] = -eps[iq] / (3.0 * self._q[iq] * k) \
                    * th_com * dl
                y[base + 2] = -0.5 * sig_nu * dl
            off += self.nq * (self.ln + 1)
        return y

    # -- full RHS -----------------------------------------------------------

    def _rhs_full(self, x, y, k):
        bg = self.bg
        a = np.exp(x)
        Hc, tau, dk, cs2, (gi, gf) = self._lookup(x)

        phi = y[0]
        dc, tc, db, tb = y[1], y[2], y[3], y[4]
        Fg = y[self._iFg:self._iFg + self.lg + 1]
        Gg = y[self._iGg:self._iGg + self.lp + 1]
        Fu = y[self._iFu:self._iFu + self.lu + 1]

        drg = self._drho_g(a)
        dru = self._drho_ur(a)
        drb = self._drho_b(a)
        drc = self._drho_c(a)

        # ncdm moments
        S_sig_n = 0.0
        S_del_n = 0.0
        ncdm_mom = []
        off = self._incdm
        for i, s in enumerate(bg.ncdm):
            eps = np.sqrt(self._q ** 2 + s.y(a) ** 2)
            P = y[off:off + self.nq * (self.ln + 1)].reshape(
                self.nq, self.ln + 1)
            We = self._Wq * eps
            norm = np.sum(We)
            drn, _, _ = self._lookup_ncdm(i, gi, gf)
            # delta-rho and sigma contributions in drho units
            S_del_n += drn * np.sum(We * P[:, 0]) / norm
            S_sig_n += drn * (2.0 / 3.0) * np.sum(
                self._Wq * self._q ** 2 / eps * P[:, 2]) / norm
            ncdm_mom.append((eps, P, drn, norm))
            off += self.nq * (self.ln + 1)

        # Einstein constraints: psi from the anisotropic stress, phidot
        # from the ENERGY constraint (23a).  Evolving phi with the
        # momentum constraint alone lets the energy constraint drift
        # through matter-radiation equality (Bianchi only propagates
        # the unused constraint if the energy constraint is the one
        # integrated) -- the classic 9/10 superhorizon dip is lost.
        S_sig = (2.0 / 3.0) * (drg * Fg[2] + dru * Fu[2]) + S_sig_n
        psi = phi - 4.5 / (k * k) * S_sig
        S_del = drg * Fg[0] + dru * Fu[0] + drb * db + drc * dc + S_del_n
        phidot = -Hc * psi - (k * k) / (3.0 * Hc) * phi \
            - S_del / (2.0 * Hc)                         # conformal d/dtau

        dy = np.empty_like(y)
        dy[0] = phidot
        dy[1] = -tc + 3.0 * phidot
        dy[2] = -Hc * tc + k * k * psi
        thg = 0.75 * k * Fg[1]
        dy[3] = -tb + 3.0 * phidot
        dy[4] = -Hc * tb + cs2 * k * k * db + k * k * psi \
            + (4.0 * drg) / (3.0 * drb) * dk * (thg - tb)

        # photon temperature hierarchy
        dFg = np.empty(self.lg + 1)
        dFg[0] = -k * Fg[1] + 4.0 * phidot
        dFg[1] = (k / 3.0) * (Fg[0] - 2.0 * Fg[2]) + (4.0 * k / 3.0) * psi \
            + dk * (4.0 * tb / (3.0 * k) - Fg[1])
        dFg[2] = (k / 5.0) * (2.0 * Fg[1] - 3.0 * Fg[3]) \
            - dk * (0.9 * Fg[2] - 0.1 * (Gg[0] + Gg[2]))
        if self.lg > 3:
            l = self._l[3:self.lg]
            dFg[3:self.lg] = k / (2 * l + 1) * (
                l * Fg[2:self.lg - 1] - (l + 1) * Fg[4:self.lg + 1]) \
                - dk * Fg[3:self.lg]
        dFg[self.lg] = k * Fg[self.lg - 1] \
            - ((self.lg + 1) / tau + dk) * Fg[self.lg]

        # polarization
        dGg = np.empty(self.lp + 1)
        src = 0.5 * (Fg[2] + Gg[0] + Gg[2])
        dGg[0] = -k * Gg[1] + dk * (-Gg[0] + src)
        l = self._l[1:self.lp]
        dGg[1:self.lp] = k / (2 * l + 1) * (
            l * Gg[0:self.lp - 1] - (l + 1) * Gg[2:self.lp + 1]) \
            - dk * Gg[1:self.lp]
        dGg[2] += dk * src / 5.0
        dGg[self.lp] = k * Gg[self.lp - 1] \
            - ((self.lp + 1) / tau + dk) * Gg[self.lp]

        # massless neutrinos
        dFu = np.empty(self.lu + 1)
        dFu[0] = -k * Fu[1] + 4.0 * phidot
        dFu[1] = (k / 3.0) * (Fu[0] - 2.0 * Fu[2]) + (4.0 * k / 3.0) * psi
        l = self._l[2:self.lu]
        dFu[2:self.lu] = k / (2 * l + 1) * (
            l * Fu[1:self.lu - 1] - (l + 1) * Fu[3:self.lu + 1])
        dFu[self.lu] = k * Fu[self.lu - 1] \
            - ((self.lu + 1) / tau) * Fu[self.lu]

        dy[self._iFg:self._iFg + self.lg + 1] = dFg
        dy[self._iGg:self._iGg + self.lp + 1] = dGg
        dy[self._iFu:self._iFu + self.lu + 1] = dFu

        # ncdm hierarchies
        off = self._incdm
        for (eps, P, drn, norm) in ncdm_mom:
            dP = np.empty_like(P)
            qk_eps = self._q * k / eps                  # (nq,)
            dP[:, 0] = -qk_eps * P[:, 1] - phidot * self._dlnf
            dP[:, 1] = qk_eps / 3.0 * (P[:, 0] - 2.0 * P[:, 2]) \
                - (eps * k / (3.0 * self._q)) * psi * self._dlnf
            if self.ln > 2:
                l = self._l[2:self.ln]
                dP[:, 2:self.ln] = qk_eps[:, None] / (2 * l + 1) * (
                    l * P[:, 1:self.ln - 1] - (l + 1) * P[:, 3:self.ln + 1])
            dP[:, self.ln] = qk_eps * P[:, self.ln - 1] \
                - ((self.ln + 1) / tau) * P[:, self.ln]
            dy[off:off + self.nq * (self.ln + 1)] = dP.ravel()
            off += self.nq * (self.ln + 1)

        # convert conformal-time derivatives to d/dlna
        return dy / Hc

    # -- tight-coupling (TCA) RHS ------------------------------------------

    def _rhs_tca(self, x, y, k):
        """Deep photon-baryon coupling: theta_g == theta_b, photon
        moments l>=2 and polarization slaved (zeroth-order TCA).  The
        raw drag term dkappa (theta_g - theta_b) is ~1e10 x stiff at
        early times and amplifies Jacobian roundoff; every Boltzmann
        code integrates this era with a TCA instead.
        State: [phi, d_c, t_c, d_b, t_gb, d_g] + F_ur + ncdm."""
        bg = self.bg
        a = np.exp(x)
        Hc, tau, _dk, cs2, (gi, gf) = self._lookup(x)

        phi = y[0]
        dc, tc, db, tgb, dg = y[1], y[2], y[3], y[4], y[5]
        Fu = y[6:6 + self.lu + 1]

        drg = self._drho_g(a)
        dru = self._drho_ur(a)
        drb = self._drho_b(a)
        drc = self._drho_c(a)

        S_sig_n = 0.0
        S_del_n = 0.0
        ncdm_mom = []
        off = 6 + self.lu + 1
        for i, s in enumerate(bg.ncdm):
            eps = np.sqrt(self._q ** 2 + s.y(a) ** 2)
            P = y[off:off + self.nq * (self.ln + 1)].reshape(
                self.nq, self.ln + 1)
            We = self._Wq * eps
            norm = np.sum(We)
            drn, _, _ = self._lookup_ncdm(i, gi, gf)
            S_del_n += drn * np.sum(We * P[:, 0]) / norm
            S_sig_n += drn * (2.0 / 3.0) * np.sum(
                self._Wq * self._q ** 2 / eps * P[:, 2]) / norm
            ncdm_mom.append((eps, P))
            off += self.nq * (self.ln + 1)

        S_sig = (2.0 / 3.0) * dru * Fu[2] + S_sig_n
        psi = phi - 4.5 / (k * k) * S_sig
        S_del = drg * dg + dru * Fu[0] + drb * db + drc * dc + S_del_n
        phidot = -Hc * psi - (k * k) / (3.0 * Hc) * phi \
            - S_del / (2.0 * Hc)

        R = (4.0 * drg) / (3.0 * drb)
        dy = np.empty_like(y)
        dy[0] = phidot
        dy[1] = -tc + 3.0 * phidot
        dy[2] = -Hc * tc + k * k * psi
        dy[3] = -tgb + 3.0 * phidot
        dy[4] = (-Hc * tgb + cs2 * k * k * db
                 + R * k * k * dg / 4.0) / (1.0 + R) + k * k * psi
        dy[5] = -(4.0 / 3.0) * tgb + 4.0 * phidot

        dFu = np.empty(self.lu + 1)
        dFu[0] = -k * Fu[1] + 4.0 * phidot
        dFu[1] = (k / 3.0) * (Fu[0] - 2.0 * Fu[2]) + (4.0 * k / 3.0) * psi
        l = self._l[2:self.lu]
        dFu[2:self.lu] = k / (2 * l + 1) * (
            l * Fu[1:self.lu - 1] - (l + 1) * Fu[3:self.lu + 1])
        dFu[self.lu] = k * Fu[self.lu - 1] \
            - ((self.lu + 1) / tau) * Fu[self.lu]
        dy[6:6 + self.lu + 1] = dFu

        off = 6 + self.lu + 1
        for (eps, P) in ncdm_mom:
            dP = np.empty_like(P)
            qk_eps = self._q * k / eps
            dP[:, 0] = -qk_eps * P[:, 1] - phidot * self._dlnf
            dP[:, 1] = qk_eps / 3.0 * (P[:, 0] - 2.0 * P[:, 2]) \
                - (eps * k / (3.0 * self._q)) * psi * self._dlnf
            if self.ln > 2:
                l = self._l[2:self.ln]
                dP[:, 2:self.ln] = qk_eps[:, None] / (2 * l + 1) * (
                    l * P[:, 1:self.ln - 1] - (l + 1) * P[:, 3:self.ln + 1])
            dP[:, self.ln] = qk_eps * P[:, self.ln - 1] \
                - ((self.ln + 1) / tau) * P[:, self.ln]
            dy[off:off + self.nq * (self.ln + 1)] = dP.ravel()
            off += self.nq * (self.ln + 1)
        return dy / Hc

    def _tca_switch_lna(self, k, lna0, trigger=0.008):
        """First lna where tight coupling stops being deep:
        H/dkappa > trigger or k/dkappa > trigger."""
        grid = np.linspace(lna0, 0.0, 800)
        dk = np.exp(self._spl_dkappa(grid))
        Hc = np.exp(self._spl_Hc(grid))
        ok = (Hc / dk > trigger) | (k / dk > trigger)
        idx = np.argmax(ok)
        if not ok[idx]:
            return 0.0
        return float(grid[idx])

    def _tca_to_full(self, y_tca, x, k):
        """Map TCA state to the full hierarchy state."""
        y = np.zeros(self.nvar)
        y[0] = y_tca[0]
        y[1:5] = y_tca[1:5]          # d_c, t_c, d_b, t_b
        dk = float(np.exp(self._spl_dkappa(x)))
        tgb = y_tca[4]
        y[self._iFg + 0] = y_tca[5]
        y[self._iFg + 1] = 4.0 * tgb / (3.0 * k)
        # slaved quadrupole estimate (relaxes to truth within steps)
        y[self._iFg + 2] = (32.0 / 45.0) * tgb / dk
        n_ur_ncdm = (self.lu + 1) + len(self.bg.ncdm) * self.nq \
            * (self.ln + 1)
        y[self._iFu:self._iFu + n_ur_ncdm] = y_tca[6:6 + n_ur_ncdm]
        return y

    def _record_tca(self, k, x, y, out, j):
        """Record outputs while in the TCA phase."""
        full = self._tca_to_full(y, x, k)
        self._record_full(k, x, full, out, j)

    # -- RSA (reduced) RHS --------------------------------------------------

    def _rhs_rsa(self, x, y, k):
        """After switch: state [phi, d_c, t_c, d_b, t_b,
        (d_nu, t_nu, sig_nu) per ncdm].  Photons/ur slaved:
        delta = -4 psi, theta = 0, sigma = 0."""
        bg = self.bg
        a = np.exp(x)
        Hc, _tau, dk, cs2, (gi, gf) = self._lookup(x)

        phi = y[0]
        dc, tc, db, tb = y[1], y[2], y[3], y[4]

        drg = self._drho_g(a)
        dru = self._drho_ur(a)
        drb = self._drho_b(a)
        drc = self._drho_c(a)

        S_sig = 0.0
        S_del = drb * db + drc * dc
        for i in range(len(bg.ncdm)):
            dn, tn, sn = y[5 + 3 * i:8 + 3 * i]
            drn, w, _cg = self._lookup_ncdm(i, gi, gf)
            S_del += drn * dn
            S_sig += drn * (1.0 + w) * sn
        psi = phi - 4.5 / (k * k) * S_sig
        # RSA radiation: delta_rad = -4 psi enters the energy constraint
        S_del += (drg + dru) * (-4.0 * psi)
        phidot = -Hc * psi - (k * k) / (3.0 * Hc) * phi \
            - S_del / (2.0 * Hc)

        dy = np.empty_like(y)
        dy[0] = phidot
        dy[1] = -tc + 3.0 * phidot
        dy[2] = -Hc * tc + k * k * psi
        # RSA photons in the drag term: theta_g ~ 0
        dy[3] = -tb + 3.0 * phidot
        dy[4] = -Hc * tb + cs2 * k * k * db + k * k * psi \
            + (4.0 * drg) / (3.0 * drb) * dk * (0.0 - tb)
        for i in range(len(bg.ncdm)):
            dn, tn, sn = y[5 + 3 * i:8 + 3 * i]
            _dr, w, cg2 = self._lookup_ncdm(i, gi, gf)
            dy[5 + 3 * i] = -(1 + w) * (tn - 3.0 * phidot) \
                - 3.0 * Hc * (cg2 - w) * dn
            dy[6 + 3 * i] = -Hc * (1 - 3 * cg2) * tn \
                + cg2 / (1 + w) * k * k * dn - k * k * sn + k * k * psi
            # viscous shear (CLASS-style ncdm fluid approximation,
            # c_vis^2 = 3 w c_g^2): damps the fluid sound waves that a
            # pressureless-shear fluid would carry undamped forever
            cvis2 = 3.0 * w * cg2
            dy[7 + 3 * i] = -3.0 * Hc * sn \
                + (8.0 / 3.0) * cvis2 / (1 + w) * tn
        return dy / Hc

    # -- mode driver --------------------------------------------------------

    def _lna_start(self, k):
        """Start when k tau = 3e-2 but always deep in RD."""
        bg = self.bg
        tau_target = 3e-2 / k
        lna = float(np.log(bg.a_of_tau(min(tau_target,
                                           bg.tau(1e-5)))))
        return min(lna, np.log(3e-6))

    def _rsa_switch_lna(self, k, lna0):
        """First lna where k*tau > rsa_ktau and dkappa*tau below
        threshold; np.inf if never."""
        grid = np.linspace(lna0, 0.0, 600)
        tau = np.exp(self._spl_tau(grid))
        dk = np.exp(self._spl_dkappa(grid))
        ok = (k * tau > self.rsa_ktau) & (dk * tau < self.rsa_dkappa_tau)
        idx = np.argmax(ok)
        if not ok[idx]:
            return np.inf
        return float(grid[idx])

    def _integrate_phase(self, rhs, x0, x1, y0, t_eval, k, atol, label):
        """solve_ivp wrapper returning (outputs at t_eval, state at x1)."""
        te = list(t_eval)
        want_end = not (len(te) and abs(te[-1] - x1) < 1e-13)
        if want_end:
            te = te + [x1]
        sol = integrate.solve_ivp(
            rhs, (x0, x1), y0, t_eval=te, method='BDF',
            rtol=self.rtol, atol=atol, args=(k,))
        if not sol.success:
            raise RuntimeError("Boltzmann %s phase failed at k=%g: %s"
                               % (label, k, sol.message))
        y_end = sol.y[:, -1]
        n_out = len(te) - 1 if want_end else len(te)
        return sol.y[:, :n_out], y_end

    def solve_mode(self, k, lna_out):
        """Integrate one k-mode (k in 1/Mpc); return dict of outputs on
        lna_out (must be increasing, ending at 0 = today).

        Runs the native C++ kernel (the root ``csrc/boltzmann_kernel.cpp``)
        unless the solver was made with ``use_native=False``, which
        selects the scipy BDF path below. A failed build or native solve
        raises."""
        if self.use_native:
            from . import _native
            return _native.solve_mode_native(self, float(k), lna_out)
        return self._solve_mode_py(k, lna_out)

    def _solve_mode_py(self, k, lna_out):
        lna0 = self._lna_start(k)
        y0_full = self._initial(k, lna0)
        x_tc = max(self._tca_switch_lna(k, lna0), lna0)
        x_sw = self._rsa_switch_lna(k, lna0)
        if x_sw <= x_tc:
            x_sw = np.inf
        lna_out = np.asarray(lna_out, dtype='f8')

        out = {q: np.empty(len(lna_out)) for q in
               ('phi', 'psi', 'd_cdm', 't_cdm', 'd_b', 't_b',
                'd_g', 't_g', 'd_ur', 't_ur', 'd_ncdm', 't_ncdm')}

        n_tca = int(np.searchsorted(lna_out, x_tc, side='left'))
        if np.isfinite(x_sw) and x_sw < 0.0:
            n_pre = int(np.searchsorted(lna_out, x_sw, side='left'))
        else:
            n_pre = len(lna_out)

        # phase 0: tight coupling
        n_tca_state = 6 + (self.lu + 1) + len(self.bg.ncdm) * self.nq \
            * (self.ln + 1)
        y0 = np.zeros(n_tca_state)
        y0[0] = y0_full[0]
        y0[1:5] = y0_full[1:5]                   # d_c,t_c,d_b,theta_gb
        y0[5] = y0_full[self._iFg + 0]           # delta_g
        y0[6:] = y0_full[self._iFu:]
        atol0 = np.full(n_tca_state, 1e-9)
        atol0[0] = 1e-11
        ys, y_end = self._integrate_phase(
            self._rhs_tca, lna0, x_tc, y0, lna_out[:n_tca], k, atol0,
            'TCA')
        for j in range(ys.shape[1]):
            self._record_tca(k, lna_out[j], ys[:, j], out, j)
        if n_tca == len(lna_out) and x_tc >= 0.0:
            return out

        # phase 1: full hierarchy
        y1 = self._tca_to_full(y_end, x_tc, k)
        atol = np.full(self.nvar, 1e-9)
        atol[0] = 1e-11
        x_end = x_sw if n_pre < len(lna_out) else 0.0
        t_eval1 = lna_out[n_tca:n_pre]
        ys, y_sw_state = self._integrate_phase(
            self._rhs_full, x_tc, x_end, y1, t_eval1, k, atol, 'full')
        for j in range(ys.shape[1]):
            self._record_full(k, t_eval1[j], ys[:, j], out, n_tca + j)

        if n_pre == len(lna_out):
            return out
        y_sw = y_sw_state

        # build RSA state
        nn = len(self.bg.ncdm)
        y2 = np.empty(5 + 3 * nn)
        y2[:5] = y_sw[:5]
        off = self._incdm
        a_sw = np.exp(x_sw)
        for i, s in enumerate(self.bg.ncdm):
            eps = np.sqrt(self._q ** 2 + s.y(a_sw) ** 2)
            P = y_sw[off:off + self.nq * (self.ln + 1)].reshape(
                self.nq, self.ln + 1)
            We = self._Wq * eps
            norm = np.sum(We)
            y2[5 + 3 * i] = np.sum(We * P[:, 0]) / norm
            w = float(self._ncdm_w[i](x_sw))
            y2[6 + 3 * i] = k * np.sum(self._Wq * self._q * P[:, 1]) \
                / norm / (1.0 + w)
            y2[7 + 3 * i] = (2.0 / 3.0) * np.sum(
                self._Wq * self._q ** 2 / eps * P[:, 2]) / norm / (1.0 + w)
            off += self.nq * (self.ln + 1)

        t_eval2 = lna_out[n_pre:]
        atol2 = np.full(len(y2), 1e-9)
        atol2[0] = 1e-11
        sol2 = integrate.solve_ivp(
            self._rhs_rsa, (x_sw, 0.0), y2, t_eval=t_eval2,
            method='BDF', rtol=self.rtol, atol=atol2, args=(k,))
        if not sol2.success:
            raise RuntimeError("Boltzmann RSA phase failed at k=%g: %s"
                               % (k, sol2.message))
        for j in range(sol2.y.shape[1]):
            self._record_rsa(k, t_eval2[j], sol2.y[:, j], out, n_pre + j)
        return out

    def _record_full(self, k, x, y, out, j):
        a = np.exp(x)
        out['phi'][j] = y[0]
        out['d_cdm'][j] = y[1]
        out['t_cdm'][j] = y[2]
        out['d_b'][j] = y[3]
        out['t_b'][j] = y[4]
        Fg = y[self._iFg:self._iFg + self.lg + 1]
        Fu = y[self._iFu:self._iFu + self.lu + 1]
        out['d_g'][j] = Fg[0]
        out['t_g'][j] = 0.75 * k * Fg[1]
        out['d_ur'][j] = Fu[0]
        out['t_ur'][j] = 0.75 * k * Fu[1]
        # ncdm density-weighted mean over species
        dtot = 0.0
        ttot = 0.0
        wsum = 0.0
        off = self._incdm
        for i, s in enumerate(self.bg.ncdm):
            eps = np.sqrt(self._q ** 2 + s.y(a) ** 2)
            P = y[off:off + self.nq * (self.ln + 1)].reshape(
                self.nq, self.ln + 1)
            We = self._Wq * eps
            norm = np.sum(We)
            drn = self._ncdm_drho[i](x)
            w = float(self._ncdm_w[i](x))
            dtot += drn * np.sum(We * P[:, 0]) / norm
            ttot += drn * k * np.sum(self._Wq * self._q * P[:, 1]) \
                / norm / (1.0 + w)
            wsum += drn
            off += self.nq * (self.ln + 1)
        out['d_ncdm'][j] = dtot / wsum if wsum else 0.0
        out['t_ncdm'][j] = ttot / wsum if wsum else 0.0
        # psi from the constraint
        S_sig = (2.0 / 3.0) * (self._drho_g(a) * Fg[2]
                               + self._drho_ur(a) * Fu[2])
        off = self._incdm
        for i, s in enumerate(self.bg.ncdm):
            eps = np.sqrt(self._q ** 2 + s.y(a) ** 2)
            P = y[off:off + self.nq * (self.ln + 1)].reshape(
                self.nq, self.ln + 1)
            We = self._Wq * eps
            norm = np.sum(We)
            S_sig += self._ncdm_drho[i](x) * (2.0 / 3.0) * np.sum(
                self._Wq * self._q ** 2 / eps * P[:, 2]) / norm
            off += self.nq * (self.ln + 1)
        out['psi'][j] = y[0] - 4.5 / (k * k) * S_sig

    def _record_rsa(self, k, x, y, out, j):
        out['phi'][j] = y[0]
        out['d_cdm'][j] = y[1]
        out['t_cdm'][j] = y[2]
        out['d_b'][j] = y[3]
        out['t_b'][j] = y[4]
        nn = len(self.bg.ncdm)
        S_sig = 0.0
        dtot = ttot = wsum = 0.0
        for i in range(nn):
            drn = self._ncdm_drho[i](x)
            w = float(self._ncdm_w[i](x))
            S_sig += drn * (1 + w) * y[7 + 3 * i]
            dtot += drn * y[5 + 3 * i]
            ttot += drn * y[6 + 3 * i]
            wsum += drn
        psi = y[0] - 4.5 / (k * k) * S_sig
        out['psi'][j] = psi
        out['d_g'][j] = -4.0 * psi
        out['t_g'][j] = 0.0
        out['d_ur'][j] = -4.0 * psi
        out['t_ur'][j] = 0.0
        out['d_ncdm'][j] = dtot / wsum if wsum else 0.0
        out['t_ncdm'][j] = ttot / wsum if wsum else 0.0


# ---------------------------------------------------------------------------
# the user-facing engine: k-grid, caching, P(k), transfer dict

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'data')


def cache_dir():
    """The user cache of solved tables: ``$NBKIT_TORCH_CLASS_CACHE``, else
    ``~/.cache/nbodykit_tpu_torch/boltzmann`` (read at each lookup)."""
    return os.environ.get(
        'NBKIT_TORCH_CLASS_CACHE',
        os.path.join(os.path.expanduser('~'), '.cache',
                     'nbodykit_tpu_torch', 'boltzmann'))


def tophat_sigma(k, pk, r):
    """sqrt of the top-hat-filtered variance of a power spectrum:
    sigma^2(r) = (1/2 pi^2) int dlnk k^3 P(k) W(kr)^2, with k a
    log-spaced grid in h/Mpc, P in (Mpc/h)^3, r in Mpc/h.  Shared by
    every sigma_r in the package (engine, LinearPower, EH amplitude)."""
    lnk = np.log(k)
    x = k * r
    w = 3.0 * (np.sin(x) - x * np.cos(x)) / x ** 3
    return float(np.sqrt(np.trapezoid(pk * (w * k) ** 2 * k, lnk)
                         / (2 * np.pi ** 2)))


def _default_kgrid(kmax_mpc):
    """1/Mpc k grid: log ends + linear BAO sampling (dk resolves the
    ~2pi/r_s ~ 0.04/Mpc wiggle period)."""
    parts = [np.logspace(-5.3, np.log10(0.014), 28, endpoint=False),
             np.arange(0.014, min(0.45, kmax_mpc), 0.0055)]
    if kmax_mpc > 0.45:
        parts.append(np.logspace(np.log10(0.45), np.log10(kmax_mpc), 26))
    k = np.concatenate(parts)
    return np.unique(k)


class BoltzmannEngine(object):
    """Solve once per cosmology; expose P(k,z), transfers, sigma8.

    Reference surface analog: classylss ``Spectra``/``Perturbs``
    (``nbodykit/cosmology/cosmology.py:115``).
    """

    def __init__(self, bg, th, A_s, n_s, P_k_max=10.0, P_z_max=100.0,
                 k_pivot=K_PIVOT_MPC, cache=True, solver_kwargs=None):
        self.bg = bg
        self.th = th
        self.A_s = float(A_s)
        self.n_s = float(n_s)
        self.P_k_max = float(P_k_max)      # h/Mpc
        self.P_z_max = float(P_z_max)
        self.k_pivot = float(k_pivot)
        self._solver_kwargs = solver_kwargs or {}
        self._cache = cache
        self._tables = None
        # where the tables came from: 'shipped', 'cache' or 'solved'
        self.source = None

    # cache key: every number that affects the transfer shapes
    def _key(self):
        bg, th = self.bg, self.th
        items = (bg.h, bg.T0_cmb, bg.Omega_b, bg.Omega_cdm, bg.Omega_k,
                 bg.Omega_ur, bg.w0_fld, bg.wa_fld, bg.use_fld,
                 tuple(s.m_ev for s in bg.ncdm), th.YHe, th.z_reio,
                 th.reio_width, th.fudge,
                 self.n_s, self.P_k_max, self.P_z_max,
                 tuple(sorted(self._solver_kwargs.items())))
        s = repr(items).encode()
        return hashlib.sha256(s).hexdigest()[:24]

    def _z_out(self):
        zmax = min(self.P_z_max, 199.0)
        z = np.concatenate([[0.0], np.expm1(np.linspace(
            np.log(1.02), np.log(1.0 + zmax), 23))])
        return np.unique(z)

    def _solve_tables(self):
        if self._tables is not None:
            return self._tables
        # shipped tables for the built-in parameter sets, then the user
        # cache
        shipped = os.path.join(_DATA_DIR, self._key() + '.npz')
        cache = cache_dir()
        path = os.path.join(cache, self._key() + '.npz')
        for source, p in (('shipped', shipped), ('cache', path)):
            if self._cache and os.path.exists(p):
                d = np.load(p)
                self._tables = {k: d[k] for k in d.files}
                self.source = source
                return self._tables

        solver = BoltzmannSolver(self.bg, self.th, **self._solver_kwargs)
        kgrid = _default_kgrid(self.P_k_max * self.bg.h)
        z_out = self._z_out()
        lna_out = np.log(1.0 / (1.0 + z_out[::-1]))   # increasing, ends 0
        names = ('phi', 'psi', 'd_cdm', 't_cdm', 'd_b', 't_b', 'd_g',
                 't_g', 'd_ur', 't_ur', 'd_ncdm', 't_ncdm')
        res = {n: np.empty((len(z_out), len(kgrid))) for n in names}
        for ik, k in enumerate(kgrid):
            mode = solver.solve_mode(float(k), lna_out)
            for n in names:
                res[n][:, ik] = mode[n][::-1]      # index 0 = z=0? no:
        # lna_out increasing => last entry is z=0; reversing gives
        # res[:,ik][0] at z=0 ordering consistent with z_out ascending
        tables = {'k': kgrid, 'z': z_out}
        tables.update(res)
        self._tables = tables
        self.source = 'solved'
        if self._cache:
            try:
                os.makedirs(cache, exist_ok=True)
                np.savez(path, **tables)
            except OSError:
                pass
        return tables

    # -- matter transfer / power -------------------------------------------

    def _gauge_shift(self, tables):
        """+3 Hc theta_cdm / k^2: Newtonian -> CDM-comoving (synchronous)
        density shift for w=0 species (delta_syn = delta_con +
        3 Hc (1+w) theta_c / k^2; checked against the O((k tau)^2)
        synchronous superhorizon densities).  The comoving-gauge delta
        is what CLASS's P(k) uses; the Newtonian superhorizon tail is a
        gauge artifact."""
        z = tables['z']
        a = 1.0 / (1.0 + z)
        Hc = self.bg.H_conformal(a)[:, None]
        return 3.0 * Hc * tables['t_cdm'] / tables['k'][None, :] ** 2

    def _delta_m(self, tables):
        """rho-weighted CDM+baryon+ncdm transfer, (nz, nk), comoving."""
        bg = self.bg
        z = tables['z']
        a = 1.0 / (1.0 + z)[:, None]
        shift = self._gauge_shift(tables)
        wb, wc = bg.Omega_b, bg.Omega_cdm
        num = wb * (tables['d_b'] + shift) + wc * (tables['d_cdm'] + shift)
        den = wb + wc
        for s in bg.ncdm:
            # mass (non-relativistic) density weight at each z
            rho = s.rho_over_rhocrit0(a[:, 0])[:, None] * a ** 3
            num = num + rho * (tables['d_ncdm'] + shift)
            den = den + rho
        return num / den

    def _delta_cb(self, tables):
        bg = self.bg
        shift = self._gauge_shift(tables)
        wb, wc = bg.Omega_b, bg.Omega_cdm
        return (wb * tables['d_b'] + wc * tables['d_cdm']) / (wb + wc) \
            + shift

    def _pk_interp(self, which='m'):
        tables = self._solve_tables()
        dm = self._delta_m(tables) if which == 'm' else \
            self._delta_cb(tables)
        k = tables['k']                      # 1/Mpc
        z = tables['z']
        prim = 2.0 * np.pi ** 2 / k ** 3 * self.A_s \
            * (k / self.k_pivot) ** (self.n_s - 1.0)
        pk = prim[None, :] * dm ** 2         # Mpc^3
        lz = np.log(1.0 + z)
        lk = np.log(k)
        return interpolate.RectBivariateSpline(
            lz, lk, np.log(pk), kx=min(3, len(lz) - 1), ky=3)

    _pk_spl = None
    _pk_cb_spl = None

    def get_pklin(self, k_h, z, which='m'):
        """Linear P(k,z): k in h/Mpc, result in (Mpc/h)^3."""
        attr = '_pk_spl' if which == 'm' else '_pk_cb_spl'
        spl = getattr(self, attr)
        if spl is None:
            spl = self._pk_interp(which)
            setattr(self, attr, spl)
        k_h = np.asarray(k_h, dtype='f8')
        z = np.asarray(z, dtype='f8')
        scalar = k_h.ndim == 0 and z.ndim == 0
        kb, zb = np.broadcast_arrays(k_h, z)
        shape = kb.shape
        k_mpc = np.atleast_1d(kb.ravel()) * self.bg.h
        zf = np.atleast_1d(zb.ravel())
        klo = np.exp(spl.get_knots()[1][0])
        khi = np.exp(spl.get_knots()[1][-1])
        kcl = np.clip(k_mpc, klo, khi)
        out = np.exp(spl.ev(np.log(1.0 + zf), np.log(kcl)))
        # tilt the below-range extrapolation like k^ns (phi const there)
        out = out * np.where(k_mpc < klo, (k_mpc / klo) ** self.n_s, 1.0)
        out = out * self.bg.h ** 3
        if scalar:
            return float(out[0])
        return out.reshape(shape)

    def sigma_r(self, r_hmpc, z=0.0, which='m'):
        """Tophat rms fluctuation; r in Mpc/h."""
        k = np.exp(np.linspace(np.log(1e-5),
                               np.log(self.P_k_max * 0.999), 1024))
        return tophat_sigma(k, self.get_pklin(k, z, which=which),
                            r_hmpc)

    _sigma8 = None

    @property
    def sigma8(self):
        if self._sigma8 is None:
            self._sigma8 = self.sigma_r(8.0)
        return self._sigma8

    # -- CLASS-format transfer dict ----------------------------------------

    def get_transfer(self, z=0.0):
        """CLASS-convention transfer dictionary at redshift z.

        Keys follow the CLASS 'format: class' output: densities d_*,
        velocities t_*, metric (newtonian phi/psi and synchronous
        h_prime/eta via gauge transformation fixed to the CDM frame).
        k is in h/Mpc (reference get_transfer convention,
        cosmology.py:115 + Spectra.get_transfer).
        """
        tables = self._solve_tables()
        zgrid = tables['z']
        iz = int(np.argmin(np.abs(zgrid - z)))
        if abs(zgrid[iz] - z) > 1e-8:
            # interpolate each column in ln(1+z)
            lz = np.log(1.0 + zgrid)
            lzq = np.log(1.0 + z)
            pick = {}
            for n in tables:
                if n in ('k', 'z'):
                    continue
                f = interpolate.interp1d(lz, tables[n], axis=0,
                                         kind='cubic')
                pick[n] = f(lzq)
        else:
            pick = {n: tables[n][iz] for n in tables
                    if n not in ('k', 'z')}

        k_mpc = tables['k']
        a = 1.0 / (1.0 + z)
        Hc = float(self.bg.H_conformal(a))
        # synchronous (CDM-comoving) gauge transformation:
        # alpha = theta_c / k^2 ; eta = phi - Hc alpha ;
        # h' = -2 k^2 alpha - 6 eta' with eta' from the theta constraint
        alpha = pick['t_cdm'] / k_mpc ** 2
        eta = pick['phi'] + Hc * alpha
        out = {'k': k_mpc / self.bg.h}
        for n in ('d_cdm', 'd_b', 'd_g', 'd_ur', 'd_ncdm',
                  't_b', 't_g', 't_ur', 't_ncdm', 'phi', 'psi'):
            v = pick[n].copy()
            if n.startswith('d_'):
                # synchronous-gauge densities (CLASS default gauge):
                # delta_syn = delta_con + 3 Hc (1+w) alpha
                w = {'d_cdm': 0.0, 'd_b': 0.0, 'd_ncdm': 0.0,
                     'd_ur': 1.0 / 3, 'd_g': 1.0 / 3}[n]
                v = v + 3.0 * Hc * (1.0 + w) * alpha
            elif n.startswith('t_'):
                # theta_syn = theta_con - k^2 alpha
                v = v - k_mpc ** 2 * alpha
            out[n] = v
        if 'd_ncdm' in out:
            out['d_ncdm[0]'] = out['d_ncdm']
        # d_tot / d_m
        bg = self.bg
        wb, wc = bg.Omega_b, bg.Omega_cdm
        num = wb * out['d_b'] + wc * out['d_cdm']
        den = wb + wc
        for s in bg.ncdm:
            rho = float(s.rho_over_rhocrit0(a)) * a ** 3
            num = num + rho * out['d_ncdm']
            den = den + rho
        out['d_m'] = num / den
        out['d_tot'] = out['d_m']
        # h_prime = +2 k^2 alpha - 6 eta'  (alpha = (h'+6 eta')/2k^2);
        # eta' from the synchronous momentum constraint:
        # eta' = (3/2)/k^2 sum drho (1+w) theta^(s), theta^s =
        # theta^N - k^2 alpha
        drg = bg.H0 ** 2 * bg.Omega_g / a ** 2
        dru = bg.H0 ** 2 * bg.Omega_ur / a ** 2
        drb = bg.H0 ** 2 * bg.Omega_b / a
        drc = bg.H0 ** 2 * bg.Omega_cdm / a
        th_s = lambda t, w: (t - k_mpc ** 2 * alpha) * (1.0 + w)
        S = drb * th_s(pick['t_b'], 0.0) + drc * th_s(pick['t_cdm'], 0.0) \
            + drg * th_s(pick['t_g'], 1.0 / 3) \
            + dru * th_s(pick['t_ur'], 1.0 / 3)
        for i, s in enumerate(bg.ncdm):
            drn = bg.H0 ** 2 * float(s.rho_over_rhocrit0(a)) * a ** 2
            wn = float(s.p_over_rhocrit0(a) / s.rho_over_rhocrit0(a))
            S = S + drn * th_s(pick['t_ncdm'], wn)
        eta_prime = 1.5 / k_mpc ** 2 * S
        out['eta'] = eta
        out['eta_prime'] = eta_prime
        out['h_prime'] = 2.0 * k_mpc ** 2 * alpha - 6.0 * eta_prime
        return out
