"""The Cosmology calculator (a copy of
``nbodykit_tpu/cosmology/cosmology.py``).

The JAX package serves the reference's classylss/CLASS surface with its
in-repo Einstein-Boltzmann engine (``cosmology/boltzmann.py``); so does
this copy:

- CLASS-style parameter handling: canonical names + ``Omega_x``/
  ``Omega0_x`` aliases, little-omega (``omega_b = Omega_b h^2``)
  inputs, ``ln10^{10}A_s``, deprecated astropy-style arguments
  (``H0``/``Om0``/``flat``…, FutureWarning), conflict detection,
  unknown-parameter warnings, immutability after construction
  (reference ``cosmology.py:556-744``).
- Background: exact massive-neutrino momentum integrals, distances,
  conformal time, growth; densities in the reference's
  :math:`10^{10} M_\\odot/h / (\\mathrm{Mpc}/h)^3` units
  (``rho_crit(0) == 27.754999``).
- Thermo: recombination/drag epochs, sound horizons, ``tau_reio``
  (with inversion when ``tau_reio`` is the input).
- ``clone``/``match``/``from_dict``/``from_file``/pickling, and the
  astropy-compat accessor names (``Odm0``, ``Onu(z)``, …).
- Spectra: ``get_pk``/``get_pklin``/``get_transfer``/``sigma8``/
  ``sigma8_z`` backed by the Boltzmann engine (shipped tables for the
  built-in parameter sets, else a disk-cached solve).

Numpy and scipy only.
"""

import warnings

import numpy as np
from scipy import integrate, interpolate, optimize

from . import boltzmann as _boltz

RHO_NORM = 27.754999101  # rho_crit/h^2 in 1e10 Msun/h / (Mpc/h)^3
C_KMS = 299792.458

# canonical parameters and their defaults (reference cosmology.py:115:
# CLASS 2.6-era defaults, which classylss bundled)
_CANON_DEFAULTS = dict(
    h=0.67556,
    T0_cmb=2.7255,
    Omega0_b=0.022032 / 0.67556 ** 2,
    Omega0_cdm=0.12038 / 0.67556 ** 2,
    Omega0_k=0.0,
    Omega0_lambda=None,        # inferred by closure unless given
    Omega0_fld=None,
    w0_fld=-1.0,
    wa_fld=0.0,
    N_ur=None,                 # inferred from N_ncdm
    m_ncdm=(0.06,),
    T_ncdm=0.71611,
    N_ncdm=None,
    n_s=0.9667,
    A_s=2.215e-9,              # CLASS 2.6 default
    k_pivot=0.05,
    P_k_max=10.0,
    P_z_max=100.0,
    gauge='synchronous',
    nonlinear=False,
    YHe=0.2454,
    z_reio=11.357,
    tau_reio=None,
    verbose=False,
)

# simple aliases -> canonical name
_ALIASES = {
    'T_cmb': 'T0_cmb',
    'Omega_b': 'Omega0_b',
    'Omega_cdm': 'Omega0_cdm',
    'Omega_k': 'Omega0_k',
    'Omega_lambda': 'Omega0_lambda',
    'Omega0_Lambda': 'Omega0_lambda',
    'Omega_Lambda': 'Omega0_lambda',
    'Omega_fld': 'Omega0_fld',
    'Omega_ncdm': 'Omega0_ncdm',
    'Omega0_ncdm': 'Omega0_ncdm',
    'ln10^{10}A_s': 'A_s',
    'ln_A_s_1e10': 'A_s',
}

# little-omega (omega = Omega h^2) inputs
_LITTLE = {'omega_b': 'Omega0_b', 'omega_cdm': 'Omega0_cdm',
           'omega_ncdm': 'Omega0_ncdm'}

_DEPRECATED = ('H0', 'Om0', 'Ode0', 'w0', 'wa', 'flat')

# N_ur defaults per CLASS notes: for 0,1,2,3 massive species with the
# default T_ncdm = 0.71611, these give N_eff = 3.046 in the early
# universe (reference cosmology.py docstring / astropy_to_dict)
_N_UR_TABLE = [3.046, 2.0328, 1.0196, 0.00641]


def _canonicalize(kwargs):
    """Normalize user kwargs into the canonical parameter dict.

    Mirrors the reference's merge/compile pipeline
    (``cosmology.py:556-744``): alias resolution, deprecated astropy
    syntax, conflicts, little-omega conversion, validation.
    """
    args = dict(kwargs)
    out = {}
    unknown = {}

    # --- deprecated astropy-style syntax --------------------------------
    # only engaged when astropy-shaped args are present; a bare H0 is a
    # valid CLASS parameter (from_file inis use it) and maps to h
    if not ({'flat', 'Om0', 'Ode0'} & set(args)):
        if 'H0' in args:
            if 'h' in args:
                raise ValueError("conflicting values for parameter 'h'"
                                 " (H0 and h both given)")
            args['h'] = args.pop('H0') / 100.0
        dep = {}
    else:
        dep = {k: args.pop(k) for k in list(args) if k in _DEPRECATED}
    if dep:
        warnings.warn("arguments %s are deprecated astropy-style "
                      "parameters; use h/Omega0_*/w0_fld instead"
                      % sorted(dep), FutureWarning)
        modern_conflicts = {'h', 'Omega0_cdm', 'Omega_cdm',
                           'Omega0_lambda', 'Omega_lambda',
                           'Omega0_Lambda', 'w0_fld',
                           'Omega0_b', 'Omega_b', 'omega_b',
                           'omega_cdm'}
        if modern_conflicts & set(args):
            raise ValueError(
                "cannot mix deprecated parameters %s with %s"
                % (sorted(dep), sorted(modern_conflicts & set(args))))
        if 'flat' not in dep:
            raise ValueError("deprecated syntax requires 'flat'")
        if 'H0' not in dep or 'Om0' not in dep:
            raise ValueError("deprecated syntax requires H0 and Om0")
        out['h'] = dep['H0'] / 100.0
        out['_Om0_target'] = dep['Om0']
        if dep.get('flat'):
            if 'Ode0' in dep:
                raise ValueError("cannot give Ode0 with flat=True")
        else:
            if 'Ode0' not in dep:
                raise ValueError("flat=False requires Ode0")
            out['_Ode0_target'] = dep['Ode0']
        if 'w0' in dep and dep['w0'] != -1.0:
            out['w0_fld'] = dep['w0']
        if 'wa' in dep and dep['wa'] != 0.0:
            out['wa_fld'] = dep['wa']

    # --- aliases and little-omega ---------------------------------------
    for k in list(args):
        target = None
        scale_h2 = False
        if k in _CANON_DEFAULTS:
            target = k
        elif k in _ALIASES:
            target = _ALIASES[k]
        elif k in _LITTLE:
            target = _LITTLE[k]
            scale_h2 = True
        if target is None:
            unknown[k] = args.pop(k)
            continue
        v = args.pop(k)
        if k == 'ln10^{10}A_s' or k == 'ln_A_s_1e10':
            v = np.exp(v) * 1e-10
        if target in out or ('_raw_' + target) in out:
            raise ValueError("conflicting values for parameter '%s'"
                             % target)
        if scale_h2:
            out['_raw_' + target] = v       # divide by h^2 later
        else:
            out[target] = v

    if unknown:
        warnings.warn("unknown cosmology parameters: %s"
                      % sorted(unknown), UserWarning)

    # resolve little-omega now that h is known
    h = out.get('h', _CANON_DEFAULTS['h'])
    for k in list(out):
        if k.startswith('_raw_'):
            tgt = k[5:]
            if tgt in out:
                raise ValueError("conflicting values for '%s'" % tgt)
            out[tgt] = out.pop(k) / h ** 2
    return out, unknown


class Cosmology(object):
    """A cosmology calculator with the reference's CLASS-backed API.

    See the module docstring; parameters follow
    ``nbodykit/cosmology/cosmology.py:115`` (same names, same
    defaults).  The object is immutable — use :meth:`clone` or
    :meth:`match` to derive variants.
    """

    def __init__(self, **kwargs):
        pars, unknown = _canonicalize(kwargs)
        self.__dict__['_extra_pars'] = unknown
        self.__dict__['_user_pars'] = pars
        self._compile(pars)
        self.__dict__['_initialized'] = True

    # -- parameter compilation -------------------------------------------

    def _compile(self, pars):
        d = dict(_CANON_DEFAULTS)
        d.update({k: v for k, v in pars.items()
                  if not k.startswith('_')})

        # massive neutrinos
        m = d['m_ncdm']
        if m is None:
            m = []
        elif np.isscalar(m):
            m = [float(m)]
        else:
            m = [float(x) for x in m]
        if any(x == 0 for x in m):
            raise ValueError("m_ncdm must not contain zero masses; "
                             "omit massless species (they belong in "
                             "N_ur)")
        d['m_ncdm'] = m
        if d['N_ncdm'] is not None and int(d['N_ncdm']) != len(m):
            raise ValueError("N_ncdm inconsistent with m_ncdm")
        d['N_ncdm'] = len(m)
        if d['N_ur'] is None:
            d['N_ur'] = _N_UR_TABLE[min(len(m), 3)]

        if d['gauge'] not in ('synchronous', 'newtonian'):
            raise ValueError("gauge must be 'synchronous' or "
                             "'newtonian', not %r" % (d['gauge'],))

        # dark energy bookkeeping (reference: Omega_Lambda vs fld,
        # cosmology.py 'Non-cosmological constant dark energy...')
        # "fld mode" means the fld component actually carries dark
        # energy: an explicit Omega0_fld=0.0 (e.g. from a dict(c)
        # round-trip of an LCDM cosmology) must NOT count
        w_mode = (d['w0_fld'] != -1.0 or d['wa_fld'] != 0.0
                  or bool(d.get('Omega0_fld')))
        if w_mode and d.get('Omega0_lambda') not in (None, 0.0, 0):
            raise ValueError("specifying w0_fld/wa_fld together with "
                             "Omega0_lambda is inconsistent; use "
                             "Omega0_fld")

        # radiation content
        h = d['h']
        Omega_g = 2.47282e-5 * (d['T0_cmb'] / 2.7255) ** 4 / h ** 2
        Omega_ur = d['N_ur'] * (7.0 / 8) * (4.0 / 11) ** (4.0 / 3) \
            * Omega_g

        # ncdm density today (exact integrals via the engine species)
        species = [_boltz.NcdmSpecies(mi, d['T0_cmb'], Omega_g)
                   for mi in m]
        Omega_ncdm = float(sum(s.rho_over_rhocrit0(1.0)
                               for s in species))
        Omega_pncdm = float(sum(3.0 * s.p_over_rhocrit0(1.0)
                                for s in species))

        # Omega0_ncdm as direct input -> rescale the masses
        if 'Omega0_ncdm' in pars:
            target = pars['Omega0_ncdm']
            if not m:
                raise ValueError("Omega0_ncdm given but no massive "
                                 "species")
            # m/93.14 scaling is exact in the non-relativistic regime
            scale = target / Omega_ncdm
            m = [mi * scale for mi in m]
            d['m_ncdm'] = m
            species = [_boltz.NcdmSpecies(mi, d['T0_cmb'], Omega_g)
                       for mi in m]
            Omega_ncdm = float(sum(s.rho_over_rhocrit0(1.0)
                                   for s in species))
            Omega_pncdm = float(sum(3.0 * s.p_over_rhocrit0(1.0)
                                    for s in species))

        # deprecated Om0 target: fix Omega0_cdm so Omega0_m == Om0
        if '_Om0_target' in pars:
            d['Omega0_cdm'] = (pars['_Om0_target']
                               - _CANON_DEFAULTS['Omega0_b']
                               - (Omega_ncdm - Omega_pncdm))
            d['Omega0_b'] = _CANON_DEFAULTS['Omega0_b']
        if '_Ode0_target' in pars:
            if w_mode:
                d['Omega0_fld'] = pars['_Ode0_target']
                d['Omega0_lambda'] = 0.0
            else:
                d['Omega0_lambda'] = pars['_Ode0_target']

        Omega_m = d['Omega0_b'] + d['Omega0_cdm'] \
            + (Omega_ncdm - Omega_pncdm)
        Omega_r = Omega_g + Omega_ur + Omega_pncdm
        budget = d['Omega0_b'] + d['Omega0_cdm'] + Omega_ncdm \
            + Omega_g + Omega_ur

        lam = d.get('Omega0_lambda')
        fld = d.get('Omega0_fld')
        if w_mode:
            lam = 0.0 if lam is None else float(lam)
            if fld is None:
                fld = 1.0 - d['Omega0_k'] - budget - lam
            else:
                fld = float(fld)
                if 'Omega0_k' not in pars:
                    d['Omega0_k'] = 1.0 - budget - lam - fld
        else:
            fld = 0.0
            if lam is None:
                lam = 1.0 - d['Omega0_k'] - budget
            else:
                lam = float(lam)
                if 'Omega0_k' not in pars:
                    d['Omega0_k'] = 1.0 - budget - lam
        d['Omega0_lambda'] = lam
        d['Omega0_fld'] = fld

        # resolve deprecated targets into modern parameters so that
        # clone()/pickle reproduce the same cosmology (the targets
        # themselves are not kept)
        if '_Om0_target' in pars or '_Ode0_target' in pars:
            up = self.__dict__['_user_pars']
            for key in ('_Om0_target', '_Ode0_target'):
                up.pop(key, None)
            up['h'] = d['h']
            up['Omega0_b'] = d['Omega0_b']
            up['Omega0_cdm'] = d['Omega0_cdm']
            up['m_ncdm'] = list(m)
            if '_Ode0_target' in pars:
                if w_mode:
                    up['Omega0_fld'] = d['Omega0_fld']
                    up['Omega0_lambda'] = 0.0
                else:
                    up['Omega0_lambda'] = d['Omega0_lambda']
            if d['w0_fld'] != -1.0:
                up['w0_fld'] = d['w0_fld']
            if d['wa_fld'] != 0.0:
                up['wa_fld'] = d['wa_fld']

        self.__dict__['_pars'] = d
        self.__dict__['_derived'] = dict(
            Omega0_g=Omega_g, Omega0_ur=Omega_ur,
            Omega0_ncdm_tot=Omega_ncdm, Omega0_pncdm_tot=Omega_pncdm,
            Omega0_m=Omega_m, Omega0_r=Omega_r)
        self.__dict__['_species'] = species
        self.__dict__['_cache'] = {}

        # reproducibility bag (kept from the round-1 API)
        attrs = dict(d)
        attrs['m_ncdm'] = list(m)
        attrs.update(self._extra_pars)
        self.__dict__['attrs'] = attrs

    # -- immutability ----------------------------------------------------

    def __setattr__(self, name, value):
        if self.__dict__.get('_initialized') and (
                name in _CANON_DEFAULTS or name in _ALIASES
                or name in _LITTLE or name in ('sigma8',)):
            raise ValueError(
                "Cosmology is immutable; use clone(%s=...) " % name)
        object.__setattr__(self, name, value)

    # -- parameter access -------------------------------------------------

    def __getattr__(self, name):
        # only called when normal lookup fails
        if name.startswith('__'):
            raise AttributeError(name)
        pars = self.__dict__.get('_pars', {})
        derived = self.__dict__.get('_derived', {})
        if name in pars:
            v = pars[name]
            return list(v) if isinstance(v, list) else v
        if name in derived:
            return derived[name]
        if name == 'Omega0_ncdm':
            return derived['Omega0_ncdm_tot']
        if name == 'Omega0_pncdm':
            return derived['Omega0_pncdm_tot']
        if name == 'Omega0_de':
            return pars['Omega0_lambda'] + pars['Omega0_fld']
        if name in _ALIASES and _ALIASES[name] != name:
            return getattr(self, _ALIASES[name])
        raise AttributeError("Cosmology has no attribute %r" % name)

    def __dir__(self):
        base = list(super().__dir__())
        base += list(self._pars) + list(self._derived)
        base += ['Background', 'Spectra', 'Perturbs', 'Primordial',
                 'Thermo', 'Omega0_ncdm', 'Omega0_pncdm']
        return sorted(set(base))

    # dict(c) support (reference: Cosmology.from_dict(dict(c)))
    def keys(self):
        return list(self._pars.keys()) + list(self._extra_pars.keys())

    def __getitem__(self, key):
        if key in self._pars:
            v = self._pars[key]
            return list(v) if isinstance(v, list) else v
        return self._extra_pars[key]

    def __iter__(self):
        return iter(self.keys())

    # -- delegates (dro-style, reference cosmology.py:115) ----------------

    @property
    def Background(self):
        return _Delegate(self, ('efunc', 'efunc_prime',
                                'hubble_function', 'comoving_distance',
                                'comoving_transverse_distance',
                                'angular_diameter_distance',
                                'luminosity_distance', 'tau',
                                'scale_independent_growth_factor',
                                'scale_independent_growth_rate',
                                'Omega_m', 'Omega_g', 'Omega_b',
                                'Omega_cdm', 'Omega_ur', 'Omega_ncdm',
                                'Omega_pncdm', 'Omega_r', 'Omega_k',
                                'Omega_lambda', 'Omega_fld',
                                'rho_crit', 'rho_m', 'rho_b', 'rho_cdm',
                                'rho_g', 'rho_ur', 'rho_ncdm', 'rho_r',
                                'rho_k', 'rho_lambda', 'rho_fld'))

    @property
    def Spectra(self):
        return _Delegate(self, ('get_pk', 'get_pklin', 'get_transfer',
                                'sigma8', 'sigma8_z', 'sigma_r',
                                'nonlinear', 'has_pk_matter'))

    @property
    def Perturbs(self):
        return _Delegate(self, ('gauge', 'P_k_max', 'P_z_max'))

    @property
    def Primordial(self):
        return _Delegate(self, ('A_s', 'n_s', 'k_pivot',
                                'get_primordial'))

    @property
    def Thermo(self):
        return _Delegate(self, ('z_rec', 'rs_rec', 'z_drag', 'rs_drag',
                                'tau_reio', 'z_reio', 'YHe',
                                'theta_s'))

    # -- engine plumbing --------------------------------------------------

    @property
    def _bg(self):
        if '_bg' not in self._cache:
            p = self._pars
            self._cache['_bg'] = _boltz.Background(
                h=p['h'], T0_cmb=p['T0_cmb'], Omega_b=p['Omega0_b'],
                Omega_cdm=p['Omega0_cdm'], Omega_k=p['Omega0_k'],
                N_ur=p['N_ur'], m_ncdm=p['m_ncdm'],
                w0_fld=p['w0_fld'], wa_fld=p['wa_fld'],
                use_fld=p['Omega0_fld'] > 0,
                Omega_lambda=p['Omega0_lambda'],
                Omega_fld=p['Omega0_fld'])
        return self._cache['_bg']

    @property
    def _th(self):
        if '_th' not in self._cache:
            p = self._pars
            if p['tau_reio'] is not None:
                zre = self._invert_tau_reio(p['tau_reio'])
            else:
                zre = p['z_reio']
            self._cache['_th'] = _boltz.Thermodynamics(
                self._bg, YHe=p['YHe'], z_reio=zre)
        return self._cache['_th']

    def _invert_tau_reio(self, target):
        """Root-find z_reio giving the requested optical depth."""
        bg = self._bg

        def f(zre):
            th = _boltz.Thermodynamics(bg, YHe=self._pars['YHe'],
                                       z_reio=zre)
            return th.tau_reio - target

        try:
            return float(optimize.brentq(f, 4.0, 20.0, xtol=1e-3))
        except ValueError:
            return float(np.clip(
                (target / 0.0925) ** (2.0 / 3) * 11.357, 4.0, 25.0))

    @property
    def engine(self):
        """The Einstein-Boltzmann engine backing Spectra."""
        if '_engine' not in self._cache:
            p = self._pars
            self._cache['_engine'] = _boltz.BoltzmannEngine(
                self._bg, self._th, A_s=p['A_s'], n_s=p['n_s'],
                P_k_max=p['P_k_max'], P_z_max=p['P_z_max'],
                k_pivot=p['k_pivot'])
        return self._cache['_engine']

    # -- background: E(z), densities --------------------------------------

    def efunc(self, z):
        """E(z) = H(z)/H0 (exact ncdm momentum integrals)."""
        z = np.asarray(z, dtype='f8')
        return np.sqrt(self._bg.E2(1.0 / (1.0 + z)))

    def efunc_prime(self, z):
        """dE/da (the reference classylss convention)."""
        z = np.asarray(z, dtype='f8')
        a = 1.0 / (1.0 + z)
        eps = 1e-5 * a               # relative step: safe at any z
        return (np.sqrt(self._bg.E2(a + eps))
                - np.sqrt(self._bg.E2(a - eps))) / (2 * eps)

    def hubble_function(self, z):
        """H(z) in the reference's units (100 E(z) h km/s/Mpc)."""
        return 100.0 * self.efunc(z)

    @property
    def H0(self):
        return 100.0 * self._pars['h']

    # per-species Omega_X(z) and rho_X(z)
    def _omega_z(self, which, z):
        z = np.asarray(z, dtype='f8')
        a = 1.0 / (1.0 + z)
        E2 = self._bg.E2(a)
        d = self._derived
        p = self._pars
        if which == 'g':
            num = d['Omega0_g'] / a ** 4
        elif which == 'ur':
            num = d['Omega0_ur'] / a ** 4
        elif which == 'b':
            num = p['Omega0_b'] / a ** 3
        elif which == 'cdm':
            num = p['Omega0_cdm'] / a ** 3
        elif which == 'ncdm':
            num = sum(s.rho_over_rhocrit0(a) for s in self._species) \
                if self._species else np.zeros_like(a)
        elif which == 'pncdm':
            num = sum(3.0 * s.p_over_rhocrit0(a)
                      for s in self._species) \
                if self._species else np.zeros_like(a)
        elif which == 'k':
            num = p['Omega0_k'] / a ** 2
        elif which == 'lambda':
            num = p['Omega0_lambda'] * np.ones_like(a)
        elif which == 'fld':
            num = p['Omega0_fld'] * self._bg.de_factor(a)
        elif which == 'm':
            num = (p['Omega0_b'] + p['Omega0_cdm']) / a ** 3
            for s in self._species:
                num = num + (s.rho_over_rhocrit0(a)
                             - 3.0 * s.p_over_rhocrit0(a))
        elif which == 'r':
            num = (d['Omega0_g'] + d['Omega0_ur']) / a ** 4
            for s in self._species:
                num = num + 3.0 * s.p_over_rhocrit0(a)
        else:
            raise ValueError(which)
        return num / E2

    def Omega_m(self, z):
        return self._omega_z('m', z)

    def Omega_r(self, z):
        return self._omega_z('r', z)

    def Omega_g(self, z):
        return self._omega_z('g', z)

    def Omega_b(self, z):
        return self._omega_z('b', z)

    def Omega_cdm(self, z):
        return self._omega_z('cdm', z)

    def Omega_ur(self, z):
        return self._omega_z('ur', z)

    def Omega_ncdm(self, z):
        return self._omega_z('ncdm', z)

    def Omega_pncdm(self, z):
        return self._omega_z('pncdm', z)

    def Omega_k(self, z):
        return self._omega_z('k', z)

    def Omega_lambda(self, z):
        return self._omega_z('lambda', z)

    def Omega_fld(self, z):
        return self._omega_z('fld', z)

    def rho_crit(self, z):
        """Critical density in 1e10 (Msun/h)/(Mpc/h)^3 (reference
        convention: rho_crit(0) == 27.754999)."""
        z = np.asarray(z, dtype='f8')
        return RHO_NORM * self._bg.E2(1.0 / (1.0 + z))

    def _rho(self, which, z):
        return self._omega_z(which, z) * self.rho_crit(z)

    def rho_m(self, z):
        return self._rho('m', z)

    def rho_b(self, z):
        return self._rho('b', z)

    def rho_cdm(self, z):
        return self._rho('cdm', z)

    def rho_g(self, z):
        return self._rho('g', z)

    def rho_ur(self, z):
        return self._rho('ur', z)

    def rho_ncdm(self, z):
        return self._rho('ncdm', z)

    def rho_r(self, z):
        return self._rho('r', z)

    def rho_k(self, z):
        return self._rho('k', z)

    def rho_lambda(self, z):
        return self._rho('lambda', z)

    def rho_fld(self, z):
        return self._rho('fld', z)

    def rho_tot(self, z):
        z = np.asarray(z, dtype='f8')
        return self.rho_crit(z) - self.rho_k(z)

    # -- distances --------------------------------------------------------

    def _dist_spl(self):
        if '_dist' not in self._cache:
            zg = np.concatenate([[0.0],
                                 np.logspace(-4, np.log10(1199.0),
                                             2048)])
            chi = integrate.cumulative_trapezoid(
                C_KMS / 100.0 / self.efunc(zg), zg, initial=0.0)
            self._cache['_dist'] = \
                interpolate.InterpolatedUnivariateSpline(zg, chi, k=3)
        return self._cache['_dist']

    def comoving_distance(self, z):
        """Line-of-sight comoving distance, Mpc/h."""
        return self._dist_spl()(np.asarray(z, dtype='f8'))

    def tau(self, z):
        """Conformal lookback time in Mpc (classylss convention:
        ``comoving_distance(z) == tau(z) * h``)."""
        return self.comoving_distance(z) / self._pars['h']

    def comoving_transverse_distance(self, z):
        chi = self.comoving_distance(z)
        Ok = self._pars['Omega0_k']
        if abs(Ok) < 1e-10:
            return chi
        dh = C_KMS / 100.0
        if Ok > 0:
            s = np.sqrt(Ok)
            return dh / s * np.sinh(s * chi / dh)
        s = np.sqrt(-Ok)
        return dh / s * np.sin(s * chi / dh)

    def angular_diameter_distance(self, z):
        return self.comoving_transverse_distance(z) \
            / (1.0 + np.asarray(z))

    def luminosity_distance(self, z):
        return self.comoving_transverse_distance(z) \
            * (1.0 + np.asarray(z))

    # -- growth -----------------------------------------------------------

    def _growth_tables(self):
        if '_growth' not in self._cache:
            lna = np.linspace(np.log(1e-4), np.log(2.0), 4096)
            a = np.exp(lna)
            E2 = self._bg.E2(a)
            dlnE2 = np.gradient(np.log(E2), lna)
            om = self._omega_z('m', 1.0 / a - 1.0)

            def rhs(la, y):
                D, dD = y
                i = np.searchsorted(lna, la)
                i = min(max(i, 1), len(lna) - 1)
                w = (la - lna[i - 1]) / (lna[i] - lna[i - 1])
                omi = om[i - 1] * (1 - w) + om[i] * w
                dE = dlnE2[i - 1] * (1 - w) + dlnE2[i] * w
                return [dD, -(2.0 + 0.5 * dE) * dD + 1.5 * omi * D]

            a0 = a[0]
            sol = integrate.solve_ivp(
                rhs, (lna[0], lna[-1]), [a0, a0], t_eval=lna,
                method='RK45', rtol=1e-8, atol=1e-12)
            D = sol.y[0]
            f = sol.y[1] / sol.y[0]
            D0 = np.interp(0.0, lna, D)
            self._cache['_growth'] = (
                interpolate.InterpolatedUnivariateSpline(
                    lna, D / D0, k=3),
                interpolate.InterpolatedUnivariateSpline(lna, f, k=3))
        return self._cache['_growth']

    def scale_independent_growth_factor(self, z):
        """D(z), normalized to D(0)=1 (reference
        Background.scale_independent_growth_factor)."""
        Dspl, _ = self._growth_tables()
        return Dspl(np.log(1.0 / (1.0 + np.asarray(z, dtype='f8'))))

    def scale_independent_growth_rate(self, z):
        """f(z) = dlnD/dlna."""
        _, fspl = self._growth_tables()
        return fspl(np.log(1.0 / (1.0 + np.asarray(z, dtype='f8'))))

    # -- spectra ----------------------------------------------------------

    @property
    def has_pk_matter(self):
        return True

    @property
    def nonlinear(self):
        return self._pars['nonlinear']

    @property
    def sigma8(self):
        """sigma8 computed from A_s via the Boltzmann engine
        (reference: Spectra.sigma8)."""
        return self.engine.sigma8

    def sigma8_z(self, z):
        """sigma8(z) from the P(k,z) tables."""
        z = np.asarray(z, dtype='f8')
        flat = np.atleast_1d(z)
        out = np.array([self.engine.sigma_r(8.0, zi) for zi in flat])
        return out.reshape(z.shape) if z.ndim else float(out[0])

    def sigma_r(self, r, z=0.0):
        return self.engine.sigma_r(r, z)

    def get_pklin(self, k, z):
        """Linear matter P(k,z): k in h/Mpc, P in (Mpc/h)^3."""
        return self.engine.get_pklin(k, z)

    def get_pk(self, k, z):
        """P(k,z): HaloFit-nonlinear when ``nonlinear=True``, else
        linear (reference Spectra.get_pk semantics)."""
        if self._pars['nonlinear']:
            from .power.halofit import HalofitPower
            z = np.asarray(z, dtype='f8')
            k = np.asarray(k, dtype='f8')
            kb, zb = np.broadcast_arrays(k, z)
            out = np.empty(kb.shape)
            for zi in np.unique(zb):
                m = zb == zi
                out[m] = HalofitPower(self, float(zi))(kb[m])
            return out if out.ndim else float(out)
        return self.get_pklin(k, z)

    def get_transfer(self, z=0.0):
        """CLASS-format transfer dict at z (reference
        Spectra.get_transfer)."""
        return self.engine.get_transfer(z)

    def get_primordial(self, k=None):
        """Primordial scalar power P_R(k) (dimensionless)."""
        if k is None:
            k = np.logspace(-5, 1, 256)
        k = np.asarray(k, dtype='f8')
        pk = self._pars['A_s'] * (k * self._pars['h']
                                  / self._pars['k_pivot']) \
            ** (self._pars['n_s'] - 1.0)
        return {'k': k, 'P_scalar': pk}

    # -- thermo -----------------------------------------------------------

    @property
    def z_rec(self):
        return self._th.z_rec

    @property
    def rs_rec(self):
        return self._th.rs_rec * self._pars['h']   # Mpc/h

    @property
    def z_drag(self):
        return self._th.z_drag

    @property
    def rs_drag(self):
        return self._th.rs_drag * self._pars['h']  # Mpc/h

    @property
    def tau_reio(self):
        return self._th.tau_reio

    @property
    def z_reio(self):
        return self._th.z_reio

    @property
    def YHe(self):
        return self._pars['YHe']

    @property
    def theta_s(self):
        """Sound horizon angle at recombination."""
        th = self._th
        chi_star = self.comoving_distance(th.z_rec) / self._pars['h']
        return th.rs_rec / chi_star

    # -- astropy-compat accessors (reference AstropyCompat) ---------------

    @property
    def Om0(self):
        return self._derived['Omega0_m']

    def Om(self, z):
        return self.Omega_m(z)

    @property
    def Odm0(self):
        return self._pars['Omega0_cdm']

    def Odm(self, z):
        return self.Omega_cdm(z)

    @property
    def Ob0(self):
        return self._pars['Omega0_b']

    def Ob(self, z):
        return self.Omega_b(z)

    @property
    def Ogamma0(self):
        return self._derived['Omega0_g']

    def Ogamma(self, z):
        return self.Omega_g(z)

    @property
    def Onu0(self):
        return self._derived['Omega0_ncdm_tot'] \
            + self._derived['Omega0_ur']

    def Onu(self, z):
        return self.Omega_ncdm(z) + self.Omega_ur(z)

    @property
    def Ok0(self):
        return self._pars['Omega0_k']

    def Ok(self, z):
        return self.Omega_k(z)

    @property
    def Ode0(self):
        return self._pars['Omega0_lambda'] + self._pars['Omega0_fld']

    def Ode(self, z):
        return self.Omega_lambda(z) + self.Omega_fld(z)

    @property
    def Tcmb0(self):
        return self._pars['T0_cmb']

    @property
    def Neff(self):
        # effective relativistic dof in the early universe
        g = self._derived['Omega0_g']
        rel = self._pars['N_ur']
        for s in self._species:
            rel += s._rel_density / ((7.0 / 8) * (4.0 / 11) ** (4.0 / 3)
                                     * g)
        return rel

    @property
    def has_massive_nu(self):
        return len(self._pars['m_ncdm']) > 0

    @property
    def m_nu(self):
        return list(self._pars['m_ncdm'])

    @property
    def w0(self):
        return self._pars['w0_fld']

    @property
    def wa(self):
        return self._pars['wa_fld']

    @property
    def Omega0_cb(self):
        """CDM + baryon density (reference cosmology.py:244)."""
        return self._pars['Omega0_b'] + self._pars['Omega0_cdm']

    # -- surgery ----------------------------------------------------------

    def clone(self, **kwargs):
        """A new Cosmology with some parameters replaced (reference
        cosmology.py clone)."""
        pars = {}
        for k, v in self._user_pars.items():
            if k.startswith('_'):
                continue
            pars[k] = v
        pars.update(self._extra_pars)
        pars.update(kwargs)
        return Cosmology(**pars)

    def match(self, sigma8=None, Omega0_cb=None, Omega0_m=None):
        """Adjust parameters to match a derived quantity (reference
        cosmology.py:253)."""
        n = sum(x is not None for x in (sigma8, Omega0_cb, Omega0_m))
        if n != 1:
            raise ValueError("give exactly one of sigma8 / Omega0_cb "
                             "/ Omega0_m")
        if sigma8 is not None:
            return self.clone(
                A_s=self._pars['A_s'] * (sigma8 / self.sigma8) ** 2)
        if Omega0_cb is not None:
            rat = Omega0_cb / self.Omega0_cb
            return self.clone(Omega0_b=self._pars['Omega0_b'] * rat,
                              Omega0_cdm=self._pars['Omega0_cdm']
                              * rat)
        d = self._derived
        cb = Omega0_m - (d['Omega0_ncdm_tot'] - d['Omega0_pncdm_tot'])
        return self.match(Omega0_cb=cb)

    # -- constructors / io ------------------------------------------------

    @classmethod
    def from_dict(cls, pars):
        """Build from a raw parameter dict (reference
        cosmology.py:407)."""
        return cls(**pars)

    @classmethod
    def from_file(cls, filename, **kwargs):
        """Build from a CLASS-style ini file of ``key = value`` lines
        (reference cosmology.py:388 via classylss.load_ini)."""
        pars = {}
        with open(filename) as ff:
            for line in ff:
                line = line.split('#')[0].strip()
                if not line or '=' not in line:
                    continue
                key, _, val = line.partition('=')
                key = key.strip()
                val = val.strip()
                pars[key] = _parse_ini_value(val)
        pars.update(kwargs)
        return cls(**pars)

    @property
    def parameter_file(self):
        """CLASS-style parameter file contents (reference:
        engine.parameter_file)."""
        lines = []
        for k in sorted(self._pars):
            v = self._pars[k]
            if isinstance(v, list):
                v = ', '.join(repr(x) for x in v)
            lines.append("%s = %s" % (k, v))
        for k in sorted(self._extra_pars):
            lines.append("%s = %s" % (k, self._extra_pars[k]))
        return "\n".join(lines)

    def __getstate__(self):
        pars = {k: v for k, v in self._user_pars.items()
                if not k.startswith('_')}
        pars.update(self._extra_pars)
        return pars

    def __setstate__(self, state):
        self.__dict__['_extra_pars'] = {}
        self.__dict__['_user_pars'] = dict(state)
        pars, unknown = _canonicalize(state)
        self.__dict__['_extra_pars'] = unknown
        self.__dict__['_user_pars'] = pars
        self._compile(pars)
        self.__dict__['_initialized'] = True

    def __reduce__(self):
        return (_cosmology_unpickle, (self.__getstate__(),))

    # -- astropy ----------------------------------------------------------

    def to_astropy(self):
        """The equivalent astropy cosmology (reference
        cosmology.py:452)."""
        try:
            from astropy import cosmology, units
        except ImportError:
            raise ImportError("astropy is not installed")
        is_flat = abs(self.Ok0) < 1e-10
        kw = dict(H0=self.H0, Om0=self.Omega0_cb, Ob0=self.Ob0,
                  Tcmb0=self.Tcmb0 * units.K, Neff=self.Neff)
        if self.has_massive_nu:
            kw['m_nu'] = units.eV * (
                [0.0] * max(0, 3 - len(self.m_nu)) + list(self.m_nu))
        w0, wa = self.w0, self.wa
        if wa != 0.0:
            cls = cosmology.Flatw0waCDM if is_flat else \
                cosmology.w0waCDM
            kw.update(w0=w0, wa=wa)
        elif w0 != -1.0:
            cls = cosmology.FlatwCDM if is_flat else cosmology.wCDM
            kw['w0'] = w0
        else:
            cls = cosmology.FlatLambdaCDM if is_flat else \
                cosmology.LambdaCDM
        if not is_flat:
            kw['Ode0'] = self.Ode0
        return cls(**kw)

    @classmethod
    def from_astropy(cls, cosmo, **kwargs):
        """Build from an astropy FLRW object (reference
        cosmology.py:467 / astropy_to_dict)."""
        from astropy import cosmology as acosmo, units
        args = {}
        args['h'] = cosmo.h
        args['T0_cmb'] = getattr(cosmo.Tcmb0, 'value', cosmo.Tcmb0)
        Ob0 = cosmo.Ob0
        if Ob0 is None or not Ob0 > 0:
            raise ValueError("please specify a value for 'Ob0'")
        args['Omega0_b'] = Ob0
        args['Omega0_cdm'] = cosmo.Om0 - Ob0
        if cosmo.has_massive_nu:
            m_nu = cosmo.m_nu
            if hasattr(m_nu, 'unit') and m_nu.unit != units.eV:
                m_nu = m_nu.to(units.eV)
            vals = sorted((float(m.value) for m in m_nu
                           if m.value > 0), reverse=True)
            args['m_ncdm'] = vals
            args['N_ur'] = (cosmo.Neff / 3.046) \
                * _N_UR_TABLE[min(len(vals), 3)]
        else:
            args['m_ncdm'] = []
            args['N_ur'] = cosmo.Neff
        args['Omega0_k'] = cosmo.Ok0
        if isinstance(cosmo, (acosmo.w0waCDM, acosmo.Flatw0waCDM)) \
                and not isinstance(cosmo, acosmo.w0wzCDM):
            args['w0_fld'] = cosmo.w0
            args['wa_fld'] = cosmo.wa
            args['Omega0_Lambda'] = 0.0
            args['Omega0_fld'] = cosmo.Ode0   # explicit: works at w0=-1
        elif isinstance(cosmo, (acosmo.wCDM, acosmo.FlatwCDM)):
            args['w0_fld'] = cosmo.w0
            args['wa_fld'] = 0.0
            args['Omega0_Lambda'] = 0.0
            args['Omega0_fld'] = cosmo.Ode0
        elif isinstance(cosmo, (acosmo.LambdaCDM,
                                acosmo.FlatLambdaCDM)):
            pass
        else:
            raise ValueError(
                "dark energy not recognized for class '%s'; valid: "
                "LambdaCDM, wCDM, w0waCDM"
                % cosmo.__class__.__name__)
        args.update(kwargs)
        return cls(**args)

    def __repr__(self):
        return ("Cosmology(h=%.4g, Omega0_m=%.4g, Omega0_b=%.4g, "
                "n_s=%.4g)" % (self.h, self.Omega0_m, self.Omega0_b,
                               self.n_s))


def _parse_ini_value(val):
    """Parse one CLASS-ini value: bool, number, comma list, or str."""
    low = val.lower()
    if low in ('true', 'yes'):
        return True
    if low in ('false', 'no'):
        return False
    if ',' in val:
        try:
            return [float(x) for x in val.split(',') if x.strip()]
        except ValueError:
            return val
    try:
        v = float(val)
        if v == int(v) and '.' not in val and 'e' not in low:
            v = int(v)
        return v
    except ValueError:
        return val


def _cosmology_unpickle(pars):
    c = object.__new__(Cosmology)
    c.__setstate__(pars)
    return c


class _Delegate(object):
    """A grouped view of Cosmology methods, mirroring the classylss
    interface objects (``c.Spectra.get_pk`` == ``c.get_pk``)."""

    def __init__(self, cosmo, names):
        object.__setattr__(self, '_cosmo', cosmo)
        object.__setattr__(self, '_names', frozenset(names))

    def __getattr__(self, name):
        if name in self._names:
            return getattr(self._cosmo, name)
        raise AttributeError(name)

    def __dir__(self):
        return sorted(self._names)
