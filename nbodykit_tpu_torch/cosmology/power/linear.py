"""Linear matter power spectrum (counterpart of
``nbodykit_tpu/cosmology/power/linear.py``).

Reference: ``nbodykit/cosmology/power/linear.py:5`` (LinearPower):
transfer selection ('CLASS' | 'EisensteinHu' | 'NoWiggleEisensteinHu'),
sigma8 normalization at z=0, assignable ``sigma8``/``redshift``.

Normalization:

- ``transfer='CLASS'``: the amplitude is ``cosmo.sigma8`` (computed
  from A_s by the Boltzmann engine), exactly the reference's scheme
  (``linear.py:57-63``: ``_norm = (sigma8/sigma_r(8, z=0))^2``).
- EH transfers: the reference still normalizes with the CLASS sigma8;
  here the EH path stays Boltzmann-free by computing the amplitude
  analytically from A_s via the exact matter-era relation
  ``delta_m(k) = (2/5) (k^2/(Omega_m H0^2)) T(k) D_md(z)`` with
  ``D_md`` the matter+Lambda growth normalized to ``a`` in matter
  domination.  This agrees with the Boltzmann sigma8 to within the
  EH transfer accuracy (a few percent).

``transfer='CLASS'`` needs the Boltzmann engine, which is not ported
yet: it raises ``NotImplementedError``. On a torch tensor ``__call__``
interpolates the (ln k, ln P) table on the tensor's device, the
counterpart of the JAX package's ``jnp.interp`` branch.
"""

import numpy as np
import torch

from . import transfers as _transfers


class LinearPower(object):
    """P_lin(k) for a cosmology at a fixed redshift.

    Parameters
    ----------
    cosmo : Cosmology
    redshift : float
    transfer : 'CLASS' (default) | 'EisensteinHu' |
        'NoWiggleEisensteinHu'
    """

    def __init__(self, cosmo, redshift, transfer='CLASS'):
        if transfer not in _transfers.available:
            raise ValueError("'transfer' should be one of %s"
                             % _transfers.available)
        self.cosmo = cosmo
        self.transfer = transfer
        self._transfer = getattr(_transfers, transfer)(cosmo, redshift)
        # EH fallback for k beyond the CLASS table range
        self._fallback = _transfers.EisensteinHu(cosmo, redshift)
        self.attrs = dict(cosmo=dict(cosmo.attrs)
                          if hasattr(cosmo, 'attrs') else {},
                          redshift=redshift, transfer=transfer)

        self._norm = 1.0
        self._z = 0.0
        self._set_redshift(0.0)
        if transfer == 'CLASS':
            self._sigma8 = cosmo.sigma8
        else:
            self._sigma8 = self._As_sigma8()
        self._norm = (self._sigma8 / self.sigma_r(8.0)) ** 2
        self._set_redshift(redshift)
        self.attrs['sigma8'] = self._sigma8

    # -- A_s-based amplitude for the Boltzmann-free EH path ---------------

    def _As_sigma8(self):
        """sigma8 from A_s via the analytic matter-era normalization."""
        c = self.cosmo
        from ..background import MatterDominated
        md = MatterDominated(Omega0_m=c.Omega0_m,
                             Omega0_lambda=c.Omega0_lambda,
                             Omega0_k=c.Omega0_k)
        # D normalized to a in matter domination: D1 has D(1)=1, so
        # D_md(1) = a_early / D1(a_early)
        g0 = float(1e-3 / md.D1(1e-3))
        H0 = 1.0 / 2997.92458                # h/Mpc
        k_pivot = getattr(c, 'k_pivot', 0.05)

        from ..boltzmann import tophat_sigma
        k = np.exp(np.linspace(np.log(1e-5), np.log(20.0), 4096))
        T = self._fallback(k)
        prim = c.A_s * (k * c.h / k_pivot) ** (c.n_s - 1.0)
        delta = 0.4 * (k * k / (c.Omega0_m * H0 * H0)) * T * g0
        # k in h/Mpc throughout -> P directly in (Mpc/h)^3
        pk = 2 * np.pi ** 2 / k ** 3 * prim * delta ** 2
        return tophat_sigma(k, pk, 8.0)

    # -- redshift / sigma8 surgery (reference semantics) ------------------

    def _set_redshift(self, z):
        self._z = float(z)
        self._transfer.redshift = self._z
        self._fallback.redshift = self._z

    @property
    def redshift(self):
        return self._z

    @redshift.setter
    def redshift(self, value):
        self._set_redshift(value)
        self.attrs['redshift'] = value
        self._table = None

    @property
    def sigma8(self):
        """The z=0 amplitude; assigning rescales the spectrum."""
        return self._sigma8

    @sigma8.setter
    def sigma8(self, value):
        self._norm *= (value / self._sigma8) ** 2
        self._sigma8 = value
        self.attrs['sigma8'] = value
        self._table = None

    # -- evaluation --------------------------------------------------------

    def _unnorm_pk(self, k, z):
        """k^ns T(k, z)^2 with EH fallback beyond the table range."""
        k = np.asarray(k, dtype='f8')
        save = self._z
        if z != save:
            self._set_redshift(z)
        try:
            if self.transfer == 'CLASS':
                kmax = getattr(self.cosmo, 'P_k_max', np.inf)
                T = np.where(k < 0.999 * kmax, self._transfer(k),
                             np.nan)
                bad = ~np.isfinite(T)
                if np.any(bad):
                    # continuity-matched EH fallback at high k
                    kj = 0.999 * kmax
                    ratio = self._transfer(kj) / self._fallback(kj)
                    T = np.where(bad, self._fallback(k) * ratio, T)
            else:
                T = self._transfer(k)
        finally:
            if z != save:
                self._set_redshift(save)
        with np.errstate(divide='ignore'):
            return np.where(k > 0, k ** self.cosmo.n_s * T * T, 0.0)

    def sigma_r(self, r, kmin=1e-5, kmax=1e1):
        """rms fluctuation in top-hat spheres of radius r Mpc/h at
        :attr:`redshift` (reference linear.py sigma_r)."""
        from ..boltzmann import tophat_sigma
        k = np.exp(np.linspace(np.log(kmin), np.log(kmax), 2048))
        return tophat_sigma(k, self._norm * self._unnorm_pk(k, self._z),
                            r)

    def velocity_dispersion(self, kmin=1e-5, kmax=10.0):
        """1D linear velocity dispersion sigma_v in Mpc/h:
        sigma_v^2 = (1/6 pi^2) int P(k) dk (reference linear.py
        velocity_dispersion)."""
        lnk = np.linspace(np.log(kmin), np.log(kmax), 2048)
        k = np.exp(lnk)
        pk = self._norm * self._unnorm_pk(k, self._z)
        val = np.trapezoid(pk * k, lnk) / (6 * np.pi ** 2)
        return float(np.sqrt(val))

    def __call__(self, k):
        """P(k) in (Mpc/h)^3, k in h/Mpc. Accepts numpy arrays or torch
        tensors (tensors are evaluated on their device through the
        interpolation table, in f64)."""
        if isinstance(k, torch.Tensor):
            return self._interp_tensor(k)
        return self._norm * self._unnorm_pk(k, self._z)

    # elements per step of the tensor interpolation, which bounds its
    # temporaries (a 1024^3 mesh's k has 5.4e8 elements)
    CHUNK = 1 << 25

    def _interp_tensor(self, k):
        """exp(interp(ln max(k, 1e-30))) on the (ln k, ln P) table, 0
        where k <= 0: ``jnp.interp`` (right-continuous bins, the end
        values outside the table) written with ``torch.searchsorted``.
        ln k is taken in k's dtype and the rest in f64, as JAX promotes
        it; returns f64."""
        lnk_t, lnp_t = self.to_table()
        xp = torch.as_tensor(lnk_t, dtype=torch.float64, device=k.device)
        fp = torch.as_tensor(lnp_t, dtype=torch.float64, device=k.device)
        flat = k.reshape(-1)
        out = torch.empty(flat.shape, dtype=torch.float64, device=k.device)
        for a in range(0, flat.numel(), self.CHUNK):
            kc = flat[a:a + self.CHUNK]
            x = torch.log(torch.clamp(kc, min=1e-30)).double()
            i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                            xp.numel() - 1)
            x0, f0 = xp[i - 1], fp[i - 1]
            f = f0 + (x - x0) / (xp[i] - x0) * (fp[i] - f0)
            f = torch.where(x < xp[0], fp[0], f)
            f = torch.where(x > xp[-1], fp[-1], f)
            out[a:a + self.CHUNK] = torch.where(kc > 0, torch.exp(f), 0.0)
        return out.reshape(k.shape)

    _table = None

    def to_table(self, kmin=1e-6, kmax=1e3, n=2048):
        """(ln k, ln P) table for the tensor interpolation."""
        if self._table is None:
            lnk = np.linspace(np.log(kmin), np.log(kmax), n)
            pk = self._norm * self._unnorm_pk(np.exp(lnk), self._z)
            self._table = (lnk, np.log(np.maximum(pk, 1e-300)))
        return self._table


def EHPower(cosmo, redshift):
    """Deprecated alias: LinearPower with the wiggly EH transfer
    (reference linear.py:200)."""
    import warnings
    warnings.warn("EHPower is deprecated; use "
                  "LinearPower(transfer='EisensteinHu')", FutureWarning)
    return LinearPower(cosmo, redshift, transfer='EisensteinHu')


def NoWiggleEHPower(cosmo, redshift):
    import warnings
    warnings.warn("NoWiggleEHPower is deprecated; use "
                  "LinearPower(transfer='NoWiggleEisensteinHu')",
                  FutureWarning)
    return LinearPower(cosmo, redshift, transfer='NoWiggleEisensteinHu')
