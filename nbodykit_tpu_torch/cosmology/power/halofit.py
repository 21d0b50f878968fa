"""Nonlinear matter power via the Halofit fitting formula (a copy of
``nbodykit_tpu/cosmology/power/halofit.py``).

Reference surface: ``nbodykit/cosmology/power/halofit.py:3``
(HalofitPower). Implemented from the published formulas: Smith et al.
2003 (astro-ph/0207664) with the Takahashi et al. 2012 (1208.2701)
revision (the same variant CLASS/CAMB use).
"""

import numpy as np
from scipy import optimize

from .linear import LinearPower


class HalofitPower(object):
    """P_nl(k) at a fixed redshift from a LinearPower via halofit.

    Parameters
    ----------
    cosmo : Cosmology
    redshift : float
    linear : optional LinearPower to reuse (else built with the default
        transfer)
    """

    def __init__(self, cosmo, redshift, linear=None):
        self.cosmo = cosmo
        self.redshift = float(redshift)
        self.linear = linear if linear is not None else \
            LinearPower(cosmo, redshift)
        self.attrs = dict(self.linear.attrs)

        # integral quantities of the linear spectrum with a Gaussian
        # window: sigma^2(R) = int dlnk Delta^2_L(k) e^{-k^2 R^2}
        lnk = np.linspace(np.log(1e-5), np.log(1e3), 2 ** 12)
        k = np.exp(lnk)
        D2 = self.linear(k) * k ** 3 / (2 * np.pi ** 2)

        def sigma2(R):
            return np.trapezoid(D2 * np.exp(-(k * R) ** 2), lnk)

        # nonlinear scale: sigma(1/ksigma) == 1
        try:
            lnR = optimize.brentq(
                lambda lr: np.log(sigma2(np.exp(lr))), np.log(1e-4),
                np.log(1e3))
        except ValueError:
            # sigma^2 < 1 everywhere: fully linear regime
            self._linear_only = True
            return
        self._linear_only = False
        R = np.exp(lnR)
        self.ksigma = 1.0 / R

        # effective index and curvature at the nonlinear scale
        eps = 1e-3
        lns = np.log([sigma2(R * np.exp(-eps)), sigma2(R),
                      sigma2(R * np.exp(eps))])
        dlns = (lns[2] - lns[0]) / (2 * eps)
        d2lns = (lns[2] - 2 * lns[1] + lns[0]) / eps ** 2
        self.neff = -3.0 - dlns
        self.C = -d2lns

        om = cosmo.Omega_m(redshift)
        ol = 1.0 - om  # flat approximation for the fit's Omega_L(z)
        w = cosmo.w0_fld
        n, C = self.neff, self.C

        # Takahashi 2012 coefficients (their eqs. A6-A13)
        self.an = 10 ** (1.5222 + 2.8553 * n + 2.3706 * n ** 2
                         + 0.9903 * n ** 3 + 0.2250 * n ** 4
                         - 0.6038 * C + 0.1749 * ol * (1 + w))
        self.bn = 10 ** (-0.5642 + 0.5864 * n + 0.5716 * n ** 2
                         - 1.5474 * C + 0.2279 * ol * (1 + w))
        self.cn = 10 ** (0.3698 + 2.0404 * n + 0.8161 * n ** 2
                         + 0.5869 * C)
        self.gamman = 0.1971 - 0.0843 * n + 0.8460 * C
        self.alphan = abs(6.0835 + 1.3373 * n - 0.1959 * n ** 2
                          - 5.5274 * C)
        self.betan = (2.0379 - 0.7354 * n + 0.3157 * n ** 2
                      + 1.2490 * n ** 3 + 0.3980 * n ** 4 - 0.1682 * C)
        self.mun = 0.0
        self.nun = 10 ** (5.2105 + 3.6902 * n)
        f1 = om ** -0.0307
        f2 = om ** -0.0585
        f3 = om ** 0.0743
        self.f1, self.f2, self.f3 = f1, f2, f3

    def __call__(self, k):
        k = np.asarray(k, dtype='f8')
        PL = self.linear(k)
        if self._linear_only:
            return PL
        D2L = PL * k ** 3 / (2 * np.pi ** 2)
        y = k / self.ksigma

        # two-halo (quasi-linear) term
        fy = y / 4.0 + y ** 2 / 8.0
        D2Q = D2L * ((1 + D2L) ** self.betan
                     / (1 + self.alphan * D2L)) * np.exp(-fy)

        # one-halo term
        with np.errstate(divide='ignore', invalid='ignore'):
            D2Hp = (self.an * y ** (3 * self.f1)
                    / (1 + self.bn * y ** self.f2
                       + (self.cn * self.f3 * y) ** (3 - self.gamman)))
            D2H = D2Hp / (1 + self.mun / y + self.nun / y ** 2)
        D2H = np.where(y > 0, D2H, 0.0)

        D2NL = D2Q + D2H
        with np.errstate(divide='ignore', invalid='ignore'):
            out = np.where(k > 0, D2NL * (2 * np.pi ** 2) / k ** 3, 0.0)
        return out

    @property
    def sigma8(self):
        return self.linear.sigma8
