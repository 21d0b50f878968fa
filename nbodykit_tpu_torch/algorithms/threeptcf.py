"""Isotropic three-point correlation function multipoles (counterpart of
``nbodykit_tpu/algorithms/threeptcf.py``).

The Slepian & Eisenstein (2015) algorithm: around every primary the
real spherical-harmonic moments a_lm(r-bin) of its neighbours
(:func:`..ops.threept_cuda.threept_alm`: the CUDA kernel on the card,
the plain fold on the CPU), then per ell

    zeta_l(b1, b2) = sum_i w_i (1 / 4 pi) sum_m a_lm(i, b1) a_lm(i, b2),

which by the addition theorem is (2 l + 1) / (4 pi)^2 times sum_i w_i
sum_{j in b1, k in b2} w_j w_k P_l(rhat_ij . rhat_ik), the reference's
normalisation. The per-ell outer product is a torch einsum per chunk of
primaries.

Across ranks (a catalog with a ``comm`` of P ranks), when the largest
edge fits a slab, the sweep is domain-decomposed as in the JAX package
(:meth:`Base3PCF._run_dist`): the particles and their ghosts within
rmax of either slab face go to the owners of balanced x-slabs, each rank
accumulates the moments of its owner copies against every copy it holds,
and one f64 ``all_reduce`` adds the zetas. A wider radius gathers the
catalog on every rank. ``.branch`` says which ran ('one_rank', 'slab'
or 'gathered').
"""

import json
import logging
import math

import numpy as np
import torch

from .. import transform
from ..binned_statistic import BinnedStatistic
from ..ops.devicehash import GridHash
from ..ops.threept_cuda import threept_alm
from ..utils import JSONEncoder
from .convpower.fkp import get_real_Ylm
from ..parallel.domain import global_bounds
from ..parallel.runtime import mesh_size

# primaries whose moments are held at once (an (n, nlm, nbins) f64 block:
# 211 MB at poles 0-4 and 13 bins)
CHUNK = 1 << 16


def se_inputs(pos, w, edges, BoxSize=None, periodic=True):
    """The grid and queries of the accumulation: (grid, w_s, p, live,
    ci), the queries being the grid's own sorted points. Periodic in
    ``BoxSize``, or (BoxSize None) in the data's bounding box, 1.001
    times its extent plus 1e-3, not periodic."""
    rmax = float(np.asarray(edges, dtype='f8')[-1])
    if BoxSize is None:
        lo = pos.min(dim=0).values
        hi = pos.max(dim=0).values
        box = ((hi - lo) * 1.001 + 1e-3).cpu().numpy()
        pos = pos - lo
        periodic = False
    else:
        box = np.ones(3) * np.asarray(BoxSize, dtype='f8')
    grid = GridHash(pos, box, rmax, periodic=periodic)
    w_s = w[grid.order].contiguous()
    p = grid.pos_s
    ci = grid.cell_of(p).contiguous()
    live = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    return grid, w_s, p, live, ci


def _zetas(grid, w_s, live, edges, ells):
    """The (nell, nbins, nbins) f64 zetas of the live queries among the
    grid's own sorted points, chunk by chunk: the moments
    (:func:`..ops.threept_cuda.threept_alm`), then the per-ell outer
    product weighted by the queries' weights."""
    nbins = len(edges) - 1
    p = grid.pos_s
    ci = grid.cell_of(p).contiguous()
    zetas = torch.zeros((len(ells), nbins, nbins), dtype=torch.float64,
                        device=p.device)
    for c0 in range(0, p.shape[0], CHUNK):
        sl = slice(c0, c0 + CHUNK)
        alm = threept_alm(grid, w_s, p[sl], live[sl], ci[sl], edges ** 2,
                          ells)
        ilm = 0
        for i, ell in enumerate(ells):
            a = alm[:, ilm:ilm + 2 * ell + 1, :]
            zetas[i] += torch.einsum('i,imb,imc->bc', w_s[sl], a, a) \
                / (4 * np.pi)
            ilm += 2 * ell + 1
        del alm
    return zetas


class Base3PCF(object):
    """The shared accumulation of SimulationBox3PCF and SurveyData3PCF."""

    def _run(self, pos, w, edges, poles, BoxSize=None, periodic=True):
        """zeta_l for f64 positions ``pos`` (N, 3) and weights ``w``
        (:func:`se_inputs` for the box)."""
        edges = np.asarray(edges, dtype='f8')
        grid, w_s, _, live, _ = se_inputs(pos, w, edges, BoxSize, periodic)
        ells = sorted(poles)
        zetas = _zetas(grid, w_s, live, edges, ells)
        return self._package(zetas.cpu().numpy(), edges, ells)

    def _run_dist(self, pos, w, edges, poles, mesh, BoxSize=None,
                  periodic=True, bounds=None):
        """zeta_l across the ranks of ``mesh`` for this rank's f64
        positions and weights (the JAX package's ``_run_dist``): the
        copies routed by :func:`..parallel.domain.slab_route`
        (``'both'``, balanced slabs), one grid over the copies this rank
        received, its owner copies the queries, one f64 ``all_reduce``
        of the zetas. Periodic in ``BoxSize``, or (BoxSize None) open in
        the bounding box ``bounds`` of every rank's positions (from
        :func:`..parallel.domain.global_bounds`), as :func:`se_inputs`."""
        from ..parallel.domain import slab_route
        edges = np.asarray(edges, dtype='f8')
        nbins = len(edges) - 1
        rmax = float(edges[-1])
        ells = sorted(poles)
        if BoxSize is None:
            lo, hi = bounds
            box = ((hi - lo) * 1.001 + 1e-3).cpu().numpy()
            pos = pos - lo
            periodic = False
        else:
            box = np.ones(3) * np.asarray(BoxSize, dtype='f8')
        n = pos.shape[0]
        route, f, _ = slab_route(pos, box, rmax, mesh, ghosts='both',
                                 periodic=periodic, balance=True)
        own = torch.zeros(f * n, dtype=torch.bool, device=pos.device)
        own[:n] = True
        (pos_r, w_r, own_r), ok, _ = route.exchange([pos, w, own])
        got = torch.nonzero(ok).squeeze(1)
        pos_r = pos_r[got].contiguous()
        if pos_r.shape[0]:
            grid = GridHash(pos_r, box, rmax, periodic=periodic)
            zetas = _zetas(grid, w_r[got][grid.order].contiguous(),
                           own_r[got][grid.order].contiguous(), edges, ells)
        else:
            zetas = torch.zeros((len(ells), nbins, nbins),
                                dtype=torch.float64, device=pos.device)
        zetas = mesh.all_reduce(zetas)
        return self._package(zetas.cpu().numpy(), edges, ells)

    def _dispatch(self, comm, pos, w, edges, poles, box, periodic,
                  bounds=None):
        """The branch of the JAX package's dispatch: one rank; the slab
        sweep where the largest edge fits ``box[0] / P``; else the
        catalog gathered on every rank. Sets ``branch``; returns the
        poles."""
        from ..parallel.domain import allgather_rows
        nproc = mesh_size(comm)
        BoxSize = None if bounds is not None else box
        if nproc > 1 and np.max(edges) <= box[0] / nproc:
            self.branch = 'slab'
            return self._run_dist(pos, w, edges, poles, comm,
                                  BoxSize=BoxSize, periodic=periodic,
                                  bounds=bounds)
        if nproc > 1:
            self.branch = 'gathered'
            pos, w = allgather_rows(pos, comm), allgather_rows(w, comm)
        else:
            self.branch = 'one_rank'
        self.logger.info("3PCF branch %s", self.branch)
        return self._run(pos, w, edges, poles, BoxSize=BoxSize,
                         periodic=periodic)

    def _package(self, zetas, edges, ells):
        nbins = len(edges) - 1
        data = {}
        centers = 0.5 * (edges[1:] + edges[:-1])
        data['r1'] = np.broadcast_to(centers[:, None], (nbins, nbins)).copy()
        data['r2'] = np.broadcast_to(centers[None, :], (nbins, nbins)).copy()
        for i, ell in enumerate(ells):
            data['corr_%d' % ell] = zetas[i]
        poles_ds = BinnedStatistic(['r1', 'r2'], [edges, edges], data)
        poles_ds.attrs.update(self.attrs)
        return poles_ds

    def save(self, output):
        with open(output, 'w') as ff:
            json.dump(dict(poles=self.poles.__getstate__(),
                           attrs=self.attrs), ff, cls=JSONEncoder)


def _weights(source, weight, n, device):
    if weight in source:
        return source[weight].to(device=device, dtype=torch.float64)
    return torch.ones(n, dtype=torch.float64, device=device)


class SimulationBox3PCF(Base3PCF):
    """zeta_l(r1, r2) in a box, on the catalog's device.

    source : catalog with Position (and Weight); poles : list of ell;
    edges : r bin edges; BoxSize : default ``source.attrs['BoxSize']``;
    periodic; weight, position : column names. Results in :attr:`poles`
    (``corr_<ell>`` columns), the same on every rank; :attr:`branch`
    (module docstring)."""

    logger = logging.getLogger('SimulationBox3PCF')

    def __init__(self, source, poles, edges, BoxSize=None,
                 periodic=True, weight='Weight', position='Position'):
        self.comm = source.comm
        if BoxSize is None:
            BoxSize = source.attrs['BoxSize']
        self.attrs = dict(poles=list(poles),
                          edges=np.asarray(edges, 'f8'),
                          BoxSize=np.ones(3) * np.asarray(BoxSize),
                          periodic=periodic)
        pos = source[position].to(torch.float64)
        w = _weights(source, weight, pos.shape[0], pos.device)
        self.poles = self._dispatch(self.comm, pos, w, edges, poles,
                                    self.attrs['BoxSize'], periodic)


class SurveyData3PCF(Base3PCF):
    """zeta_l(r1, r2) of survey (sky) data, positions from (ra, dec,
    redshift) with ``cosmo``, in the data's bounding box (across ranks,
    the box of every rank's positions)."""

    logger = logging.getLogger('SurveyData3PCF')

    def __init__(self, source, poles, edges, cosmo, ra='RA', dec='DEC',
                 redshift='Redshift', weight='Weight'):
        self.comm = source.comm
        self.attrs = dict(poles=list(poles), edges=np.asarray(edges, 'f8'))
        pos = transform.SkyToCartesian(source[ra], source[dec],
                                       source[redshift],
                                       cosmo).to(torch.float64)
        w = _weights(source, weight, pos.shape[0], pos.device)
        bounds = span = None
        if mesh_size(self.comm) > 1:
            bounds = global_bounds(pos, self.comm)
            span = ((bounds[1] - bounds[0]) * 1.001 + 1e-3).cpu().numpy()
        self.poles = self._dispatch(self.comm, pos, w, edges, poles, span,
                                    False, bounds=bounds)


class YlmCache(object):
    """Complex spherical harmonics Y_lm, m = 0..l, of Cartesian unit
    vectors, as the reference's cache: ``YlmCache(ells)(xpyhat, zhat)``
    with ``xpyhat`` the complex x + iy returns {(l, m): values}. Built
    from the real harmonics of :func:`.convpower.fkp.get_real_Ylm`:
    Y_l^m = (Y_lm + i Y_l,-m) / sqrt(2) for m > 0, Y_l^0 = Y_l0 (the
    Condon-Shortley phase lives in the real harmonics). Numpy in, numpy
    out; tensors in, tensors out."""

    def __init__(self, ells, comm=None):
        self.ells = np.asarray(ells).astype(int)
        self.max_ell = int(self.ells.max())
        self.ell_to_iell = np.empty(self.max_ell + 1, dtype=int)
        for iell, ell in enumerate(self.ells):
            self.ell_to_iell[ell] = iell
        self._fns = {}
        for ell in self.ells:
            for m in range(0, ell + 1):
                fp = get_real_Ylm(ell, m)
                self._fns[(ell, m)] = (fp, None if m == 0
                                       else get_real_Ylm(ell, -m))

    def __call__(self, xpyhat, zhat):
        tensors = isinstance(xpyhat, torch.Tensor)
        xpy = xpyhat if tensors else torch.as_tensor(np.asarray(xpyhat))
        z = zhat if isinstance(zhat, torch.Tensor) \
            else torch.as_tensor(np.asarray(zhat))
        x = xpy.real if xpy.is_complex() else xpy
        y = xpy.imag if xpy.is_complex() else torch.zeros_like(x)
        toret = {}
        s = 1.0 / math.sqrt(2.0)
        for (ell, m), (fp, fm) in self._fns.items():
            if fm is None:
                v = fp(x, y, z)
            else:
                v = s * torch.complex(fp(x, y, z), fm(x, y, z))
            toret[(ell, m)] = v if tensors else v.numpy()
        return toret
