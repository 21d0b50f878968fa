"""Galaxy power spectrum with primordial non-Gaussianity (a copy of
``nbodykit_tpu/cosmology/power/galaxy.py``).

Reference: ``nbodykit/cosmology/power/galaxy.py:6`` (FNLGalaxyPower):
P_g(k) = (b1 + 2 f_NL (b1 - p) delta_c / alpha(k))^2 P_lin(k), with
alpha(k) = 2 k^2 T(k) D(z) c^2 / (3 Omega_m H0^2) relating density and
potential.
"""

import numpy as np

from .linear import LinearPower
from .transfers import EisensteinHu

DELTA_C = 1.686
C_KMS = 299792.458


class FNLGalaxyPower(object):
    """Biased galaxy power with scale-dependent fNL bias.

    Parameters
    ----------
    cosmo : Cosmology
    redshift : float
    b1 : linear bias
    fnl : local-type f_NL
    p : 1 (mass-selected) to 1.6 (recent mergers)
    """

    def __init__(self, cosmo, redshift, b1=2.0, fnl=0.0, p=1.0,
                 transfer='CLASS'):
        self.cosmo = cosmo
        self.redshift = float(redshift)
        self.b1 = b1
        self.fnl = fnl
        self.p = p
        self.linear = LinearPower(cosmo, redshift, transfer=transfer)
        self._transfer = self.linear._transfer
        self.attrs = dict(self.linear.attrs)
        self.attrs.update(b1=b1, fnl=fnl, p=p)

    def alpha(self, k):
        """The density-potential conversion alpha(k); growth normalized
        so D(a) = a in matter domination (the g(z) convention)."""
        k = np.asarray(k, dtype='f8')
        c = self.cosmo
        # the transfer classes apply D(redshift) internally
        # (transfers.py:144,187), so only the matter-domination
        # renormalization Dmd = D(z_md) (1+z_md) remains here
        z_md = 50.0
        Dmd = c.scale_independent_growth_factor(z_md) * (1 + z_md)
        g = Dmd
        T = self._transfer(k)
        H0 = 100.0  # h km/s/Mpc
        with np.errstate(divide='ignore'):
            out = 2.0 * k ** 2 * T * g * C_KMS ** 2 \
                / (3.0 * c.Omega0_m * H0 ** 2)
        return out

    def bias_k(self, k):
        """Total scale-dependent bias b(k)."""
        if self.fnl == 0:
            return self.b1 * np.ones_like(np.asarray(k, dtype='f8'))
        with np.errstate(divide='ignore'):
            db = (2.0 * self.fnl * (self.b1 - self.p) * DELTA_C
                  / self.alpha(k))
        return self.b1 + db

    def __call__(self, k):
        k = np.asarray(k, dtype='f8')
        return self.bias_k(k) ** 2 * self.linear(k)

    @property
    def sigma8(self):
        return self.linear.sigma8
