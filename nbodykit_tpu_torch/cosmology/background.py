"""Background perturbation growth solvers.

Reference: ``nbodykit/cosmology/background.py:4-330`` — ODE solvers for
the linear growth of perturbations in 1LPT/2LPT, in matter- or
radiation-dominated approximations. The reference exposes
``Perturbation``/``MatterDominated``/``RadiationDominated`` classes used
by the lognormal mocks and the Zel'dovich power; the same surface is
provided here over scipy's ODE integrator.

Quantities (all functions of scale factor a):
  D1, f1   — first-order growth factor/rate
  D2, f2   — second-order growth factor/rate
  Gp, gp   — (1LPT momentum growth) used in velocity assignments
"""

import numpy as np
from scipy import integrate, interpolate


class Perturbation(object):
    """Growth-function solver for a general E(a) background."""

    def __init__(self, cosmo, a_normalize=1.0):
        self.cosmo = cosmo
        self.a_normalize = a_normalize
        self._solved = None

    def efunc(self, a):
        return self.cosmo.efunc(1.0 / a - 1.0)

    def Om(self, a):
        return self.cosmo.Omega_m(1.0 / a - 1.0)

    def _solve(self):
        if self._solved is not None:
            return self._solved
        lna = np.linspace(np.log(1e-5), np.log(2.0), 8192)
        a_arr = np.exp(lna)

        def dlnEdlna(a):
            eps = 1e-5
            return (np.log(self.efunc(a * np.exp(eps)))
                    - np.log(self.efunc(a * np.exp(-eps)))) / (2 * eps)

        def rhs(y, la):
            a = np.exp(la)
            D1, dD1, D2, dD2 = y
            om = self.Om(a)
            damp = 2.0 + dlnEdlna(a)
            # first order: D1'' + damp D1' - 1.5 om D1 = 0
            # second order: D2'' + damp D2' - 1.5 om D2 = -1.5 om D1^2
            return [dD1, -damp * dD1 + 1.5 * om * D1,
                    dD2, -damp * dD2 + 1.5 * om * D2 - 1.5 * om * D1 ** 2]

        a0 = a_arr[0]
        # matter-domination initial conditions: D1 = a, D2 = -3/7 a^2
        y0 = [a0, a0, -3.0 / 7 * a0 ** 2, -6.0 / 7 * a0 ** 2]
        sol = integrate.odeint(rhs, y0, lna, rtol=1e-9, atol=1e-12)
        D1, dD1, D2, dD2 = sol.T

        norm = np.interp(self.a_normalize, a_arr, D1)
        with np.errstate(all='ignore'):
            f1 = dD1 / D1
            f2 = dD2 / D2
        self._solved = dict(
            a=a_arr,
            D1=interpolate.InterpolatedUnivariateSpline(a_arr, D1 / norm),
            f1=interpolate.InterpolatedUnivariateSpline(a_arr, f1),
            D2=interpolate.InterpolatedUnivariateSpline(
                a_arr, D2 / norm ** 2),
            f2=interpolate.InterpolatedUnivariateSpline(a_arr, f2),
        )
        return self._solved

    def D1(self, a, order=0):
        return self._solve()['D1'](a, nu=order)

    def f1(self, a):
        return self._solve()['f1'](a)

    def D2(self, a, order=0):
        return self._solve()['D2'](a, nu=order)

    def f2(self, a):
        return self._solve()['f2'](a)

    def E(self, a):
        return self.efunc(a)

    def Gp(self, a):
        """1LPT momentum growth: Gp = D1 * f1 * a^2 E(a) (used in
        velocity assignment; reference background.py)."""
        return self.D1(a) * self.f1(a) * a ** 2 * self.E(a)


class MatterDominated(Perturbation):
    """Growth in a matter + Lambda (+curvature) background, ignoring
    radiation (reference background.py:207) — the solver the lognormal
    mocks use."""

    def __init__(self, Omega0_m, Omega0_lambda=None, Omega0_k=0.0,
                 a=None, a_normalize=1.0):
        if Omega0_lambda is None:
            Omega0_lambda = 1.0 - Omega0_m - Omega0_k
        self.Omega0_m = Omega0_m
        self.Omega0_lambda = Omega0_lambda
        self.Omega0_k = Omega0_k
        self.a_normalize = a_normalize
        self._solved = None

    def efunc(self, a):
        a = np.asarray(a, dtype='f8')
        return np.sqrt(self.Omega0_m * a ** -3
                       + self.Omega0_k * a ** -2 + self.Omega0_lambda)

    def Om(self, a):
        a = np.asarray(a, dtype='f8')
        return self.Omega0_m * a ** -3 / self.efunc(a) ** 2


class RadiationDominated(Perturbation):
    """Growth including the radiation contribution to the background
    (reference background.py:258)."""

    def __init__(self, cosmo, a=None, a_normalize=1.0):
        Perturbation.__init__(self, cosmo, a_normalize=a_normalize)
