"""Matter transfer functions (a copy of
``nbodykit_tpu/cosmology/power/transfers.py``).

Reference: ``nbodykit/cosmology/power/transfers.py`` — CLASS (:8),
EisensteinHu (:73), NoWiggleEisensteinHu (:184). The CLASS transfer is
served by the port's Einstein-Boltzmann engine
(``cosmology/boltzmann.py``); the analytic Eisenstein & Hu 1998
(astro-ph/9709112) forms are implemented from the published paper.

All transfers are normalized to T -> 1 as k -> 0 and take k in h/Mpc.
"""

import numpy as np

available = ['CLASS', 'EisensteinHu', 'NoWiggleEisensteinHu']

# minimum k value representing k -> 0 (reference transfers.py:6)
KMIN = 1e-8


class CLASS(object):
    """The linear matter transfer from the Boltzmann engine:
    ``T(k) = sqrt(P_lin(k)/k^ns)`` normalized to unity at low k at
    z = 0 (reference transfers.py:9-73)."""

    def __init__(self, cosmo, redshift):
        self.cosmo = cosmo
        self._norm = 1.0
        self.redshift = 0
        self._norm = 1.0 / self(KMIN)
        self.redshift = redshift

    def __call__(self, k):
        k = np.asarray(k, dtype='f8')
        scalar = k.ndim == 0
        k = np.atleast_1d(k)
        nonzero = k > 0
        # P in (Mpc/h)^3 -> Mpc^3; primordial in 1/Mpc units
        linearP = self.cosmo.get_pklin(
            np.maximum(k, KMIN), self.redshift) / self.cosmo.h ** 3
        primordialP = (np.maximum(k, KMIN) * self.cosmo.h) \
            ** self.cosmo.n_s
        Tk = np.ones(k.shape)
        D = self.cosmo.scale_independent_growth_factor(self.redshift)
        Tk[~nonzero] = 1.0 * D
        Tk[nonzero] = self._norm * np.sqrt(
            np.maximum(linearP / primordialP, 0.0))[nonzero]
        return Tk[0] if scalar else Tk


class EisensteinHu(object):
    """Full Eisenstein & Hu 1998 transfer function with BAO wiggles."""

    def __init__(self, cosmo, redshift=0):
        self.cosmo = cosmo
        self.redshift = redshift

        h = cosmo.h
        Ob = cosmo.Omega0_b
        Om = cosmo.Omega0_b + cosmo.Omega0_cdm  # baryons + CDM
        self.Obh2 = Ob * h ** 2
        self.Omh2 = Om * h ** 2
        self.f_baryon = Ob / Om
        self.theta_cmb = cosmo.T0_cmb / 2.7

        # redshift and wavenumber of equality (EH98 eqs. 2-3)
        self.z_eq = 2.5e4 * self.Omh2 * self.theta_cmb ** -4
        self.k_eq = 0.0746 * self.Omh2 * self.theta_cmb ** -2  # 1/Mpc

        # drag epoch (eq. 4)
        b1 = 0.313 * self.Omh2 ** -0.419 * (1 + 0.607 * self.Omh2 ** 0.674)
        b2 = 0.238 * self.Omh2 ** 0.223
        self.z_drag = (1291 * self.Omh2 ** 0.251
                       / (1. + 0.659 * self.Omh2 ** 0.828)
                       * (1. + b1 * self.Obh2 ** b2))

        # sound horizon at drag (eqs. 5-6)
        self.r_drag = 31.5 * self.Obh2 * self.theta_cmb ** -4 \
            * (1000. / (1 + self.z_drag))
        self.r_eq = 31.5 * self.Obh2 * self.theta_cmb ** -4 \
            * (1000. / self.z_eq)
        self.sound_horizon = (2. / (3. * self.k_eq)
                              * np.sqrt(6. / self.r_eq)
                              * np.log((np.sqrt(1 + self.r_drag)
                                        + np.sqrt(self.r_drag + self.r_eq))
                                       / (1 + np.sqrt(self.r_eq))))
        # Silk damping (eq. 7)
        self.k_silk = (1.6 * self.Obh2 ** 0.52 * self.Omh2 ** 0.73
                       * (1 + (10.4 * self.Omh2) ** -0.95))  # 1/Mpc

        # CDM suppression (eqs. 11-12)
        a1 = (46.9 * self.Omh2) ** 0.670 \
            * (1 + (32.1 * self.Omh2) ** -0.532)
        a2 = (12.0 * self.Omh2) ** 0.424 \
            * (1 + (45.0 * self.Omh2) ** -0.582)
        self.alpha_c = a1 ** (-self.f_baryon) \
            * a2 ** (-self.f_baryon ** 3)
        b1c = 0.944 / (1 + (458 * self.Omh2) ** -0.708)
        b2c = (0.395 * self.Omh2) ** -0.0266
        self.beta_c = 1. / (1 + b1c * ((1 - self.f_baryon) ** b2c - 1))

        # baryon parameters (eqs. 14-15, 23-24)
        y = (1 + self.z_eq) / (1 + self.z_drag)
        Gy = y * (-6 * np.sqrt(1 + y)
                  + (2 + 3 * y) * np.log((np.sqrt(1 + y) + 1)
                                         / (np.sqrt(1 + y) - 1)))
        self.alpha_b = 2.07 * self.k_eq * self.sound_horizon \
            * (1 + self.r_drag) ** -0.75 * Gy
        self.beta_b = (0.5 + self.f_baryon
                       + (3 - 2 * self.f_baryon)
                       * np.sqrt((17.2 * self.Omh2) ** 2 + 1))
        self.beta_node = 8.41 * self.Omh2 ** 0.435

    def __call__(self, k):
        """T(k), k in h/Mpc."""
        k = np.asarray(k, dtype='f8') * self.cosmo.h  # to 1/Mpc
        out = np.ones_like(k)
        valid = k > 0
        kv = np.where(valid, k, 1.0)

        q = kv / (13.41 * self.k_eq)
        ks = kv * self.sound_horizon

        # CDM part (eqs. 17-20)
        def T0(q, alpha, beta):
            C = 14.2 / alpha + 386. / (1 + 69.9 * q ** 1.08)
            return (np.log(np.e + 1.8 * beta * q)
                    / (np.log(np.e + 1.8 * beta * q) + C * q * q))

        f = 1. / (1 + (ks / 5.4) ** 4)
        Tc = f * T0(q, 1.0, self.beta_c) \
            + (1 - f) * T0(q, self.alpha_c, self.beta_c)

        # baryon part (eq. 21)
        s_tilde = self.sound_horizon \
            / (1 + (self.beta_node / ks) ** 3) ** (1. / 3)
        with np.errstate(invalid='ignore'):
            j0 = np.sinc(kv * s_tilde / np.pi)
        Tb = (T0(q, 1.0, 1.0) / (1 + (ks / 5.2) ** 2)
              + self.alpha_b / (1 + (self.beta_b / ks) ** 3)
              * np.exp(-(kv / self.k_silk) ** 1.4)) * j0

        T = self.f_baryon * Tb + (1 - self.f_baryon) * Tc
        out = np.where(valid, T, 1.0)
        # reference transfers.py:182: growth applied inside the transfer
        return out * self.cosmo.scale_independent_growth_factor(
            self.redshift)


class NoWiggleEisensteinHu(object):
    """EH98 'no-wiggle' shape-only transfer (their section 4.2)."""

    def __init__(self, cosmo, redshift=0):
        self.cosmo = cosmo
        self.redshift = redshift
        h = cosmo.h
        Ob = cosmo.Omega0_b
        Om = cosmo.Omega0_b + cosmo.Omega0_cdm
        self.Obh2 = Ob * h ** 2
        self.Omh2 = Om * h ** 2
        self.f_baryon = Ob / Om
        self.theta_cmb = cosmo.T0_cmb / 2.7

        # approximate sound horizon (eq. 26), Mpc
        self.sound_horizon = (44.5 * np.log(9.83 / self.Omh2)
                              / np.sqrt(1 + 10 * self.Obh2 ** 0.75))
        # alpha_gamma (eq. 31)
        self.alpha_gamma = (1 - 0.328 * np.log(431 * self.Omh2)
                            * self.f_baryon
                            + 0.38 * np.log(22.3 * self.Omh2)
                            * self.f_baryon ** 2)

    def __call__(self, k):
        k = np.asarray(k, dtype='f8') * self.cosmo.h
        out = np.ones_like(k)
        valid = k > 0
        kv = np.where(valid, k, 1.0)
        ks = kv * self.sound_horizon / self.cosmo.h  # note: s in Mpc
        # effective shape (eqs. 28-30)
        gamma_eff = self.Omh2 / self.cosmo.h * (
            self.alpha_gamma + (1 - self.alpha_gamma)
            / (1 + (0.43 * kv * self.sound_horizon) ** 4))
        q = kv / self.cosmo.h * self.theta_cmb ** 2 / gamma_eff
        L0 = np.log(2 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1 + 62.5 * q)
        T = L0 / (L0 + C0 * q * q)
        # reference transfers.py:255: growth applied inside the transfer
        return np.where(valid, T, 1.0) \
            * self.cosmo.scale_independent_growth_factor(self.redshift)


