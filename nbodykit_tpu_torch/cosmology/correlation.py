"""Correlation-function utilities: pk<->xi transforms and the (a copy of
``nbodykit_tpu/cosmology/correlation.py``).
CorrelationFunction wrapper.

Reference: ``nbodykit/cosmology/correlation.py`` (pk_to_xi :39,
xi_to_pk :8, CorrelationFunction :70), there built on mcfit; here on
:mod:`nbodykit_tpu_torch.ops.fftlog`.
"""

import numpy as np
from scipy import interpolate

from ..ops.fftlog import pk_to_xi_fftlog, xi_to_pk_fftlog


def pk_to_xi(k, Pk, ell=0, extrap=True):
    """Return a spline xi_l(r) from samples of P(k).

    Parameters mirror the reference's pk_to_xi: log-spaced k recommended;
    with ``extrap`` the input is power-law extended before transforming.
    """
    k = np.asarray(k, dtype='f8')
    Pk = np.asarray(Pk, dtype='f8')
    if extrap:
        k, Pk = _extend_loglog(k, Pk)
    r, xi = pk_to_xi_fftlog(k, Pk, ell=ell)
    sel = (r > 1e-3) & (r < 1e4)
    return interpolate.InterpolatedUnivariateSpline(r[sel], xi[sel], k=3)


def xi_to_pk(r, xi, ell=0, extrap=False):
    """Return a spline P_l(k) from samples of xi(r)."""
    r = np.asarray(r, dtype='f8')
    xi = np.asarray(xi, dtype='f8')
    if extrap:
        r, xi = _extend_loglog(r, xi)
    k, pk = xi_to_pk_fftlog(r, xi, ell=ell)
    sel = (k > 1e-5) & (k < 1e3)
    return interpolate.InterpolatedUnivariateSpline(k[sel], pk[sel], k=3)


def _extend_loglog(x, y, nlo=128, nhi=128):
    """Power-law extrapolation of (x, y) at both log ends."""
    lx, ly = np.log(x), np.log(np.abs(y) + 1e-300)
    slo = (ly[1] - ly[0]) / (lx[1] - lx[0])
    shi = (ly[-1] - ly[-2]) / (lx[-1] - lx[-2])
    shi = min(shi, -1.01)  # force decay on the high end
    dx = lx[1] - lx[0]
    xlo = np.exp(lx[0] + dx * np.arange(-nlo, 0))
    xhi = np.exp(lx[-1] + dx * np.arange(1, nhi + 1))
    ylo = y[0] * (xlo / x[0]) ** slo
    yhi = y[-1] * (xhi / x[-1]) ** shi
    return (np.concatenate([xlo, x, xhi]),
            np.concatenate([ylo, y, yhi]))


class CorrelationFunction(object):
    """xi(r) computed from any power-spectrum callable (reference
    correlation.py:70)."""

    def __init__(self, power, kmin=1e-5, kmax=1e2, nk=2048):
        self.power = power
        self.attrs = dict(getattr(power, 'attrs', {}))
        k = np.logspace(np.log10(kmin), np.log10(kmax), nk)
        self._spline = pk_to_xi(k, np.asarray(power(k)))
        if hasattr(power, 'redshift'):
            self.redshift = power.redshift

    def __call__(self, r):
        return self._spline(np.asarray(r, dtype='f8'))
