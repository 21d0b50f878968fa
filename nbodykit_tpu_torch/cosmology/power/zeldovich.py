"""Zel'dovich-approximation power spectrum (a copy of
``nbodykit_tpu/cosmology/power/zeldovich.py``).

Reference surface: ``nbodykit/cosmology/power/zeldovich.py:27``
(ZeldovichPower), which evaluates the standard ZA resummation via a
tower of mcfit/FFTLog integrals (:186-238). Implemented here from the
published formulation (e.g. Vlah, White & Aviles 2015):

  X(q) = 1/(2 pi^2) int dk P_L(k) [2/3 - 2 j1(kq)/(kq)]
  Y(q) = 1/(2 pi^2) int dk P_L(k) [-2 j0(kq) + 6 j1(kq)/(kq)]

  P_ZA(k) = 4 pi int dq q^2 [ e^{-k^2 (X+Y)/2}
              sum_n (k Y(q) / q)^n j_n(kq)  -  e^{-k^2 sigma_psi^2} j0(kq) ]

where sigma_psi^2 = X(inf)/2 is the one-axis displacement dispersion;
the subtraction removes the unclustered (q -> inf) plateau. The n-sum is
truncated adaptively (the reference uses a similar truncation).

Validated by the low-k limit P_ZA -> P_L (tests/test_cosmology.py).
"""

import numpy as np
from scipy.special import spherical_jn
from scipy import interpolate

from .linear import LinearPower


class ZeldovichPower(object):
    """P_ZA(k) at a fixed redshift.

    Parameters
    ----------
    cosmo : Cosmology
    redshift : float
    transfer : transfer for the underlying LinearPower
    nmax : maximum order in the Bessel tower (default 32)
    """

    def __init__(self, cosmo, redshift, transfer='CLASS', nmax=32):
        self.cosmo = cosmo
        self.redshift = float(redshift)
        self.linear = LinearPower(cosmo, redshift, transfer=transfer)
        self.nmax = int(nmax)
        self.attrs = dict(self.linear.attrs)
        self._tables()

    def _tables(self):
        # k-grid for the linear power integrals
        lnk = np.linspace(np.log(1e-5), np.log(1e3), 2 ** 12)
        k = np.exp(lnk)
        P = self.linear(k)

        # q-grid for X, Y (smooth in log q; wide range so the final
        # transform can reach q ~ 1/k for low k)
        q = np.logspace(-2, 5, 1536)
        kq = np.outer(q, k)
        j0 = spherical_jn(0, kq)
        with np.errstate(invalid='ignore', divide='ignore'):
            j1_over = np.where(kq > 1e-8, spherical_jn(1, kq) / kq,
                               1.0 / 3.0)
        pref = 1.0 / (2 * np.pi ** 2)
        # integrate in dlnk: dk = k dlnk
        X = pref * np.trapezoid(P * k * (2.0 / 3 - 2 * j1_over), lnk,
                                axis=-1)
        Y = pref * np.trapezoid(P * k * (-2 * j0 + 6 * j1_over), lnk,
                                axis=-1)
        self.sigma_psi2 = pref * np.trapezoid(P * k / 3.0, lnk)
        # X, Y splines; the evaluation grid is built per k (linear
        # spacing resolving the j_n(kq) period; a fixed extent q_t is
        # enough because the q > q_t remainder is handled analytically)
        self._Xs = interpolate.InterpolatedUnivariateSpline(q, X, k=3)
        self._Ys = interpolate.InterpolatedUnivariateSpline(q, Y, k=3)

        # analytic linearized transform: expanding to first order in
        # the displacement correlators,
        #   (damp - plateau) j0 ~ plateau (-k^2/2) DW j0,
        #   damp (kY/q) j1    ~ plateau (kY/q) j1,
        # the ALL-q integrals evaluate in closed form via
        # Weber-Schafheitlin:
        #   n=0: plateau [P_L(k) - 2 k^2 int_k^inf P_L/k'^3 dk']
        #   n=1: plateau [        + 2 k^2 int_k^inf P_L/k'^3 dk']
        # so the linearized total is exactly plateau * P_L(k).  The
        # evaluation therefore combines the nonlinear-minus-linearized
        # integrand on (0, q_t] (whose slowly-decaying tails cancel)
        # with plateau * P_L(k).
        self._Plin_spl = interpolate.InterpolatedUnivariateSpline(
            lnk, P, k=3)

    _q_t = 4000.0

    def _qgrid(self, kk):
        period = 2 * np.pi / kk
        dq = min(period / 16.0, 1.5)
        n = min(int(self._q_t / dq), 1 << 19)
        return np.linspace(dq, self._q_t, n)

    def __call__(self, k):
        k = np.atleast_1d(np.asarray(k, dtype='f8'))
        out = np.zeros_like(k)
        for i, kk in enumerate(k):
            if kk <= 0:
                continue
            q = self._qgrid(kk)
            X = self._Xs(q)
            Y = self._Ys(q)
            DW = X + Y - 2.0 * self.sigma_psi2
            damp = np.exp(-0.5 * kk ** 2 * (X + Y))
            plateau = np.exp(-kk ** 2 * self.sigma_psi2)
            kq = kk * q
            j0 = spherical_jn(0, kq)
            # n = 0 and n = 1 minus their linearized versions
            lin0 = plateau * (-0.5 * kk * kk) * DW
            integ = (damp - plateau - lin0) * j0
            kY_over_q = kk * Y / q
            integ = integ + (damp - plateau) * kY_over_q \
                * spherical_jn(1, kq)
            # higher-order tower (support entirely within q_t)
            fac = kY_over_q.copy()
            for n in range(2, self.nmax + 1):
                fac = fac * kY_over_q
                term = damp * fac * spherical_jn(n, kq)
                integ = integ + term
                if np.max(np.abs(term * q ** 2)) < 1e-10 * max(
                        1e-30, np.max(np.abs(integ * q ** 2))):
                    break
            out[i] = 4 * np.pi * np.trapezoid(integ * q ** 2, q) \
                + plateau * float(self._Plin_spl(np.log(kk)))
        return out if out.shape != (1,) else out[0]

    @property
    def sigma8(self):
        return self.linear.sigma8
