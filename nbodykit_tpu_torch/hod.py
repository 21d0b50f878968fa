"""HOD: halo occupation models and mock population (counterpart of
``nbodykit_tpu/hod.py``).

The occupation functions (Zheng07, Leauthaud11, the decorated
Hearin15) are numpy and scipy, as in the JAX package. Population draws
with the port's threefry (``rng.split``, ``uniform``, ``poisson``,
``normal``) on the halos' device, so a seed gives the JAX package's
galaxies; the rest of it runs on the host.

Across ranks (halos with a ``comm`` of P ranks) population follows the
JAX package, which gathers the halo columns to the host: every rank
gathers the whole columns, draws the same whole streams and builds the
galaxy catalog on the halos' ``comm``, keeping its row split of the
galaxies. A seed drawn for ``seed=None`` is rank 0's.
"""

import numpy as np
import torch
from scipy import special

from . import rng
from .source.catalog.array import ArrayCatalog
from .utils import as_numpy
from .parallel.runtime import mesh_size


class PopulatedHaloCatalog(ArrayCatalog):
    """The galaxy catalog produced by HOD population (reference
    source/catalog/halos.py PopulatedHaloCatalog): an ArrayCatalog
    that remembers the ``model`` that made it. With a ``comm`` of P
    ranks each rank is given the whole columns and keeps its rows, as
    an ArrayCatalog does."""

    def __init__(self, data, model=None, comm=None, device=None, **attrs):
        ArrayCatalog.__init__(self, data, device=device, comm=comm, **attrs)
        self.model = model


class Zheng07Model(object):
    """The 5-parameter Zheng07 HOD:

    <N_cen>(M) = 1/2 [1 + erf((logM - logMmin)/sigma_logM)]
    <N_sat>(M) = <N_cen> ((M - M0)/M1)^alpha  for M > M0

    Parameters match the conventional names (logMmin, sigma_logM,
    logM0, logM1, alpha); reference surface: hod.py:53.
    """

    def __init__(self, logMmin=13.031, sigma_logM=0.38, logM0=13.27,
                 logM1=14.08, alpha=0.76):
        self.params = dict(logMmin=logMmin, sigma_logM=sigma_logM,
                           logM0=logM0, logM1=logM1, alpha=alpha)

    def mean_ncen(self, M):
        p = self.params
        logM = np.log10(M)
        return 0.5 * (1 + special.erf(
            (logM - p['logMmin']) / p['sigma_logM']))

    def mean_nsat(self, M):
        p = self.params
        M0 = 10 ** p['logM0']
        M1 = 10 ** p['logM1']
        base = np.clip((M - M0) / M1, 0, None)
        return self.mean_ncen(M) * base ** p['alpha']


class Leauthaud11Model(object):
    """The Leauthaud et al. 2011 stellar-mass-threshold HOD
    (arXiv:1103.2077 eqs. 2-8, built on the Behroozi et al. 2010
    stellar-to-halo-mass relation, arXiv:1001.0015 eq. 21). The
    reference exposes this model as a halotools factory
    (``nbodykit/hod.py:191``); here the occupation functions are
    implemented directly.

    Centrals: the probability a halo of mass ``Mh`` hosts a galaxy
    above the stellar threshold, a lognormal-scatter erf of the SHMR:

        <Ncen>(Mh) = 1/2 [1 - erf((log10 m*_t - log10 f_SHMR(Mh))
                                  / (sqrt(2) sigma_logM*))]

    Satellites: a power law modulated by the central occupation:

        <Nsat>(Mh) = <Ncen>(Mh) (Mh/Msat)^alpha exp(-Mcut/Mh)
        Msat = 1e12 Bsat (Mh_t/1e12)^betasat,
        Mcut = 1e12 Bcut (Mh_t/1e12)^betacut,  Mh_t = f_SHMR^-1(m*_t)

    Defaults are the Leauthaud et al. 2012 SIG_MOD1 z~0.37 best fit
    (the same values halotools ships as the 'leauthaud11' defaults).
    Masses in Msun/h units; ``threshold`` is log10 of the stellar
    threshold.
    """

    def __init__(self, threshold=10.5, smhm_m0=10.72, smhm_m1=12.35,
                 smhm_beta=0.43, smhm_delta=0.56, smhm_gamma=1.54,
                 scatter=0.2, alphasat=1.0, bsat=10.62, betasat=0.859,
                 bcut=1.47, betacut=-0.13):
        self.params = dict(
            threshold=threshold, smhm_m0=smhm_m0, smhm_m1=smhm_m1,
            smhm_beta=smhm_beta, smhm_delta=smhm_delta,
            smhm_gamma=smhm_gamma, scatter=scatter, alphasat=alphasat,
            bsat=bsat, betasat=betasat, bcut=bcut, betacut=betacut)
        # Behroozi10 gives log10 Mh(m*) in closed form; tabulate it on
        # a dense stellar-mass grid and interpolate the inverse
        self._logms_grid = np.linspace(7.0, 12.8, 2048)
        self._logmh_grid = self._log_mhalo(self._logms_grid)
        p = self.params
        self._log_mh_thresh = float(self._log_mhalo(
            np.atleast_1d(p['threshold']))[0])
        mh_t12 = 10.0 ** (self._log_mh_thresh - 12.0)
        self._Msat = 1e12 * p['bsat'] * mh_t12 ** p['betasat']
        self._Mcut = 1e12 * p['bcut'] * mh_t12 ** p['betacut']

    def _log_mhalo(self, log_mstar):
        """Behroozi et al. 2010 eq. 21: log10 Mh as a function of
        log10 m* (the mean relation f_SHMR^-1)."""
        p = self.params
        r = 10.0 ** (log_mstar - p['smhm_m0'])  # m*/M*,0
        return (p['smhm_m1'] + p['smhm_beta'] * (log_mstar - p['smhm_m0'])
                + r ** p['smhm_delta'] / (1.0 + r ** (-p['smhm_gamma']))
                - 0.5)

    def _log_mstar(self, M):
        """f_SHMR(Mh): numerical inverse of the (monotone) SHMR."""
        logM = np.log10(np.clip(np.asarray(M, dtype='f8'), 1.0, None))
        return np.interp(logM, self._logmh_grid, self._logms_grid)

    def mean_ncen(self, M):
        p = self.params
        arg = (p['threshold'] - self._log_mstar(M)) \
            / (np.sqrt(2.0) * p['scatter'])
        return 0.5 * (1.0 - special.erf(arg))

    def mean_nsat(self, M):
        p = self.params
        M = np.asarray(M, dtype='f8')
        return (self.mean_ncen(M) * (M / self._Msat) ** p['alphasat']
                * np.exp(-self._Mcut / np.clip(M, 1.0, None)))


def _decorate(base, strength, percentile, split, upper=None):
    """Decorated-HOD perturbation (Hearin et al. 2016,
    arXiv:1512.03050): halos above the ``split`` percentile of the
    secondary property get ``base + strength * dmax`` and those below
    are compensated so the mass-binned mean is preserved exactly.
    ``dmax`` is the largest upper-branch perturbation keeping BOTH
    branches inside [0, upper] (the compensating lower-branch shift is
    ``-dmax * (1-split)/split``, so its own floor/ceiling bounds dmax
    too — without that, any split != 0.5 lets the clip break the
    mean)."""
    base = np.asarray(base, dtype='f8')
    frac_hi = 1.0 - split
    ratio = frac_hi / max(split, 1e-12)  # |delta_lo| = ratio*|delta_hi|
    if upper is None:
        up_room = np.inf
    else:
        up_room = upper - base
    if strength >= 0:
        # high branch rises (needs headroom), low branch falls
        # (needs floor): delta_hi <= min(up_room, base/ratio)
        dmax = np.minimum(up_room, base / max(ratio, 1e-12))
    else:
        # high branch falls, low branch rises
        dmax = np.minimum(base, up_room / max(ratio, 1e-12))
    delta_hi = strength * dmax
    delta_lo = -delta_hi * ratio
    out = np.where(np.asarray(percentile) >= split,
                   base + delta_hi, base + delta_lo)
    return np.clip(out, 0.0, upper)


class Hearin15Model(Leauthaud11Model):
    """Assembly-biased (decorated) Leauthaud11 HOD (Hearin & Watson
    2015 / Hearin et al. 2016 decorated-HOD framework; the reference's
    'hearin15' halotools factory, ``nbodykit/hod.py:192``): occupations
    additionally depend on the halo's concentration percentile at
    fixed mass. ``assembias_strength`` in [-1, 1] scales the maximal
    mean-preserving perturbation for centrals
    (``assembias_strength_sat`` for satellites, defaulting to the
    same value); ``split`` is the percentile boundary."""

    uses_assembly_bias = True

    def __init__(self, threshold=10.5, split=0.5, assembias_strength=0.5,
                 assembias_strength_sat=None, **kwargs):
        super().__init__(threshold=threshold, **kwargs)
        for name, val in [('assembias_strength', assembias_strength),
                          ('assembias_strength_sat',
                           assembias_strength_sat)]:
            if val is not None and not -1.0 <= val <= 1.0:
                # beyond +-1 the perturbation exceeds the bound dmax
                # was computed for and the clip would silently shift
                # the mass-binned mean
                raise ValueError("%s must lie in [-1, 1], got %r"
                                 % (name, val))
        if not 0.0 < split < 1.0:
            raise ValueError("split must lie in (0, 1), got %r" % split)
        self.params.update(
            split=split, assembias_strength=assembias_strength,
            assembias_strength_sat=(
                assembias_strength if assembias_strength_sat is None
                else assembias_strength_sat))

    def mean_ncen(self, M, percentile=None):
        base = super().mean_ncen(M)
        if percentile is None:
            return base
        p = self.params
        return _decorate(base, p['assembias_strength'], percentile,
                         p['split'], upper=1.0)

    def mean_nsat(self, M, percentile=None):
        base = super().mean_nsat(M)  # undecorated (percentile-free)
        if percentile is None:
            return base
        p = self.params
        return _decorate(base, p['assembias_strength_sat'], percentile,
                         p['split'], upper=None)


def mass_binned_percentile(M, secondary, nbins=20):
    """Rank-percentile of ``secondary`` among halos of similar mass
    (the conditioning variable of decorated-HOD assembly bias): log-M
    is split into ``nbins`` equal-count bins and each halo gets its
    secondary-property rank within its bin, in [0, 1)."""
    M = np.asarray(M, dtype='f8')
    sec = np.asarray(secondary, dtype='f8')
    order = np.argsort(np.argsort(M, kind='stable'), kind='stable')
    # equal-count mass bins via the rank of M
    b = (order * nbins) // max(len(M), 1)
    pct = np.zeros(len(M), dtype='f8')
    for bi in np.unique(b):
        sel = b == bi
        r = np.argsort(np.argsort(sec[sel], kind='stable'),
                       kind='stable')
        pct[sel] = (r + 0.5) / sel.sum()
    return pct


# uniforms bracketed at a time by _sample_nfw_radius: its (rows, 256) f64
# tables take 32 MiB, where one table of every satellite would take
# gigabytes at a million satellites
NFW_ROWS = 1 << 14


def _sample_nfw_radius(u, conc):
    """Scaled NFW radii r/rvir of the uniforms ``u`` by inverse-CDF
    interpolation on a common grid: m(x) = ln(1+cx) - cx/(1+cx),
    normalized at x = 1 (host numpy). The grid of each distinct
    concentration is computed once (a halo's satellites share it) and
    the uniforms are bracketed ``NFW_ROWS`` at a time: element for
    element the arithmetic of one (n, 256) table, in a fraction of its
    time and memory."""
    x_grid = np.logspace(-3, 0, 256)

    def m(x, c):
        cx = c * x
        return np.log(1 + cx) - cx / (1 + cx)

    u = np.asarray(u)
    cu, inv = np.unique(np.asarray(conc), return_inverse=True)
    mtab = m(x_grid[None, :], cu[:, None])
    mtab = mtab / mtab[:, -1:]
    out = np.empty(len(u))
    for s in range(0, len(u), NFW_ROWS):
        sl = slice(s, s + NFW_ROWS)
        mgrid, us = mtab[inv[sl]], u[sl]
        # bracket u in each row, then interpolate linearly between the
        # bracketing grid points
        j = (mgrid < us[:, None]).sum(axis=1)
        j = np.clip(j, 1, len(x_grid) - 1)
        r = np.arange(len(us))
        m_lo = mgrid[r, j - 1]
        m_hi = mgrid[r, j]
        t = np.where(m_hi > m_lo, (us - m_lo) / np.where(
            m_hi > m_lo, m_hi - m_lo, 1.0), 0.0)
        out[sl] = x_grid[j - 1] + t * (x_grid[j] - x_grid[j - 1])
    return out


class HODModel(object):
    """Populate a halo catalog with galaxies under an occupation model
    (default Zheng07). ``seed=None`` draws a seed from ``np.random``;
    across ranks the first population replaces it by rank 0's, so every
    rank draws the same galaxies."""

    def __init__(self, occupation=None, seed=None):
        self.occupation = occupation or Zheng07Model()
        self._seed_drawn = seed is None
        self.seed = seed if seed is not None else \
            np.random.randint(0, 2 ** 31 - 1)

    def _shared_seed(self, comm):
        """The model's seed, rank 0's when it was drawn here (one
        broadcast, the first time across ranks)."""
        if self._seed_drawn and mesh_size(comm) > 1:
            self.seed = int(comm.broadcast(torch.tensor(
                [self.seed], dtype=torch.int64, device=comm.device)))
            self._seed_drawn = False
        return self.seed

    def populate(self, halos, seed=None):
        """A PopulatedHaloCatalog of galaxies on the halos' device, with
        Position, Velocity, gal_type (0 central, 1 satellite) and
        HaloMass. Across ranks the halo columns are gathered to every
        rank (:func:`.parallel.domain.allgather_rows`), the draws are
        the whole streams on every rank, and the catalog is built on the
        halos' ``comm`` (each rank keeps its rows of the galaxies)."""
        from .parallel.domain import allgather_rows
        comm = halos.comm
        seed = self._shared_seed(comm) if seed is None else seed
        dev = halos.device
        k_cen, k_sat, k_rad, k_dir, k_vel = rng.split(rng.key(seed), 5)

        def whole(name):
            return as_numpy(allgather_rows(halos[name], comm))

        M = whole('Mass')
        pos = whole('Position')
        vel = whole('Velocity') if 'Velocity' in halos \
            else np.zeros_like(pos)
        try:
            rvir = whole('Radius')
        except Exception:
            rvir = 0.3 * (M / 1e13) ** (1.0 / 3)
        conc = None
        if 'Concentration' in halos:
            try:
                conc = whole('Concentration')
            except Exception:
                conc = None
        has_conc = conc is not None
        if conc is None:
            # a mass-scaling stand-in, for the NFW radii only (never
            # fed to the assembly-bias percentile)
            conc = 7.0 * (M / 1e13) ** -0.1

        biased = getattr(self.occupation, 'uses_assembly_bias', False)
        if biased and has_conc:
            pct = mass_binned_percentile(M, conc)
            ncen_mean = self.occupation.mean_ncen(M, percentile=pct)
            nsat_mean = self.occupation.mean_nsat(M, percentile=pct)
        else:
            if biased:
                import warnings
                warnings.warn(
                    "assembly-biased occupation requested but the halo "
                    "catalog has no 'Concentration' column; populating "
                    "with the undecorated occupations")
            ncen_mean = self.occupation.mean_ncen(M)
            nsat_mean = self.occupation.mean_nsat(M)

        # JAX's default float under x64: f8 uniforms and normals
        has_cen = as_numpy(rng.uniform(k_cen, (len(M),), 'f8',
                                       device=dev)) < ncen_mean
        nsat = as_numpy(rng.poisson(k_sat, np.asarray(nsat_mean, 'f8'),
                                    device=dev))
        nsat = nsat * has_cen  # satellites require a central

        cen_pos = pos[has_cen]
        cen_vel = vel[has_cen]

        # satellites: repeat halos, sample NFW radii + isotropic dirs
        idx = np.repeat(np.arange(len(M)), nsat)
        ntot_sat = len(idx)
        if ntot_sat > 0:
            u = as_numpy(rng.uniform(k_rad, (ntot_sat,), 'f8', device=dev))
            x = _sample_nfw_radius(u, conc[idx])
            dirs = as_numpy(rng.normal(k_dir, (ntot_sat, 3), 'f8',
                                       device=dev))
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            sat_pos = pos[idx] + (x * rvir[idx])[:, None] * dirs
            # virial-scaled random velocities
            sigv = 100.0 * np.sqrt(M[idx] / 1e13)  # km/s scaling
            sat_vel = vel[idx] + sigv[:, None] * as_numpy(
                rng.normal(k_vel, (ntot_sat, 3), 'f8', device=dev))
        else:
            sat_pos = np.empty((0, 3))
            sat_vel = np.empty((0, 3))

        gal_pos = np.concatenate([cen_pos, sat_pos])
        gal_vel = np.concatenate([cen_vel, sat_vel])
        gal_type = np.concatenate([np.zeros(len(cen_pos), dtype='i4'),
                                   np.ones(len(sat_pos), dtype='i4')])
        halo_mass = np.concatenate([M[has_cen], M[idx]]) \
            if ntot_sat else M[has_cen]

        if 'BoxSize' in halos.attrs:
            box = np.ones(3) * np.asarray(halos.attrs['BoxSize'])
            gal_pos = np.mod(gal_pos, box)

        cat = PopulatedHaloCatalog(
            {'Position': gal_pos, 'Velocity': gal_vel,
             'gal_type': gal_type, 'HaloMass': halo_mass},
            model=self, device=dev, comm=comm, **halos.attrs)
        cat.attrs['seed'] = seed
        cat.attrs.update(self.occupation.params)
        return cat

    def __call__(self, halos, seed=None):
        return self.populate(halos, seed=seed)


def HODModelFactory(occupation=None, **kwargs):
    """Build an HODModel (the reference's factory name)."""
    return HODModel(occupation=occupation, **kwargs)
