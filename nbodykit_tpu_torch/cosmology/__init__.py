"""Cosmology: background evolution and linear power spectra (counterpart
of ``nbodykit_tpu/cosmology/``, numpy and scipy only).

The JAX package serves the reference's classylss surface with an
in-repo Einstein-Boltzmann engine plus the analytic Eisenstein-Hu
transfer functions the reference also ships
(``cosmology/power/transfers.py:73-255``). This port has the
background, the thermodynamics and the Eisenstein-Hu path; the engine
(CLASS transfer, sigma8), HalofitPower, ZeldovichPower and the
correlation functions are not ported yet (ROADMAP, Queue A).

Built-in parameter sets mirror the reference's
(``cosmology/__init__.py``): astropy parameter values + the published
amplitude/tilt/reionization kwargs (astropy itself is not available in
this environment, so the values are inlined and documented).
"""

from .cosmology import Cosmology
from .background import Perturbation, MatterDominated, RadiationDominated
from .power.linear import LinearPower, EHPower, NoWiggleEHPower

# Planck13: astropy Planck13 (H0=67.77, Om0=0.30712, Ob0=0.048252,
# Tcmb0=2.7255, Neff=3.046, one 0.06 eV neutrino) + Planck 2014 XVI
# Table 5 amplitude/tilt (reference cosmology/__init__.py kwargs)
Planck13 = Cosmology(h=0.6777, T0_cmb=2.7255, Omega0_b=0.048252,
                     Omega0_cdm=0.30712 - 0.048252, m_ncdm=[0.06],
                     N_ur=2.0328, n_s=0.9611, k_pivot=0.05,
                     tau_reio=0.0952, **{'ln10^{10}A_s': 3.0973})

# Planck15: astropy Planck15 (H0=67.74, Om0=0.3075, Ob0=0.0486) +
# Planck 2016 XIII Table 4 (TT, TE, EE + lowP + lensing + ext)
Planck15 = Cosmology(h=0.6774, T0_cmb=2.7255, Omega0_b=0.0486,
                     Omega0_cdm=0.3075 - 0.0486, m_ncdm=[0.06],
                     N_ur=2.0328, n_s=0.9667, k_pivot=0.05,
                     tau_reio=0.066, **{'ln10^{10}A_s': 3.064})

# WMAP5/7/9: astropy parameter sets (massless neutrinos, Neff=3.04)
# + the reference's amplitude kwargs (k_pivot = 0.002/Mpc)
WMAP5 = Cosmology(h=0.702, T0_cmb=2.725, Omega0_b=0.0459,
                  Omega0_cdm=0.277 - 0.0459, m_ncdm=None, N_ur=3.04,
                  A_s=2.46e-9, k_pivot=0.002, n_s=0.962,
                  tau_reio=0.088)
WMAP7 = Cosmology(h=0.704, T0_cmb=2.725, Omega0_b=0.0455,
                  Omega0_cdm=0.272 - 0.0455, m_ncdm=None, N_ur=3.04,
                  A_s=2.42e-9, k_pivot=0.002, n_s=0.967,
                  tau_reio=0.085)
WMAP9 = Cosmology(h=0.6932, T0_cmb=2.725, Omega0_b=0.04628,
                  Omega0_cdm=0.2865 - 0.04628, m_ncdm=None, N_ur=3.04,
                  A_s=2.464e-9, k_pivot=0.002, n_s=0.9608,
                  tau_reio=0.081)

__all__ = ['Cosmology', 'LinearPower', 'EHPower', 'NoWiggleEHPower',
           'Perturbation', 'MatterDominated', 'RadiationDominated',
           'Planck13', 'Planck15', 'WMAP5', 'WMAP7', 'WMAP9']
