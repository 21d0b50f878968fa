"""Background and thermodynamics of the linear Einstein-Boltzmann engine
(a copy of the part of ``nbodykit_tpu/cosmology/boltzmann.py`` that
``Cosmology`` and the Eisenstein-Hu path use).

- **Background**: exact massive-neutrino (ncdm) energy density and
  pressure from Fermi-Dirac momentum integrals (Gauss-Laguerre), photon
  + ultra-relativistic species, CPL dark energy, curvature; conformal
  time tables.
- **Thermodynamics**: Saha helium + effective three-level (Peebles /
  RECFAST-style) hydrogen recombination with Compton-coupled baryon
  temperature, tanh reionization, Thomson opacity, sound horizon,
  recombination / drag redshifts.
- ``tophat_sigma``: the top-hat variance every sigma_r uses.

The perturbation solver (``BoltzmannSolver``) and its engine
(``BoltzmannEngine``: the CLASS transfer, the native solve over the root
``csrc/boltzmann_kernel.cpp`` and the cached tables) are not ported yet;
``Cosmology.engine`` raises until they are (ROADMAP, Queue A).
Everything here is host-side numpy/scipy.
"""

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
