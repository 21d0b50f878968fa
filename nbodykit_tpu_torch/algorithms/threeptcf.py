"""Isotropic three-point correlation function multipoles (counterpart of
``nbodykit_tpu/algorithms/threeptcf.py``), on one device; the JAX
package's domain-decomposed ``_run_dist`` waits for the multi-GPU port.

The Slepian & Eisenstein (2015) algorithm: around every primary the
real spherical-harmonic moments a_lm(r-bin) of its neighbours
(:func:`..ops.threept_cuda.threept_alm`: the CUDA kernel on the card,
the plain fold on the CPU), then per ell

    zeta_l(b1, b2) = sum_i w_i (1 / 4 pi) sum_m a_lm(i, b1) a_lm(i, b2),

which by the addition theorem is (2 l + 1) / (4 pi)^2 times sum_i w_i
sum_{j in b1, k in b2} w_j w_k P_l(rhat_ij . rhat_ik), the reference's
normalisation. The per-ell outer product is a torch einsum per chunk of
primaries.
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
from ..parallel.runtime import require_one_rank
from ..parallel.runtime import require_one_rank

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


class Base3PCF(object):
    """The shared accumulation of SimulationBox3PCF and SurveyData3PCF."""

    def _run(self, pos, w, edges, poles, BoxSize=None, periodic=True):
        """zeta_l for f64 positions ``pos`` (N, 3) and weights ``w``
        (:func:`se_inputs` for the box)."""
        edges = np.asarray(edges, dtype='f8')
        nbins = len(edges) - 1
        grid, w_s, p, live, ci = se_inputs(pos, w, edges, BoxSize, periodic)
        ells = sorted(poles)
        zetas = torch.zeros((len(ells), nbins, nbins), dtype=torch.float64,
                            device=p.device)
        for c0 in range(0, p.shape[0], CHUNK):
            sl = slice(c0, c0 + CHUNK)
            alm = threept_alm(grid, w_s, p[sl], live[sl], ci[sl],
                              edges ** 2, ells)
            ilm = 0
            for i, ell in enumerate(ells):
                a = alm[:, ilm:ilm + 2 * ell + 1, :]
                zetas[i] += torch.einsum('i,imb,imc->bc', w_s[sl], a, a) \
                    / (4 * np.pi)
                ilm += 2 * ell + 1
            del alm
        return self._package(zetas.cpu().numpy(), edges, ells)

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
    """zeta_l(r1, r2) in a box, on the catalog's device (single-device
    branch of the JAX class).

    source : catalog with Position (and Weight); poles : list of ell;
    edges : r bin edges; BoxSize : default ``source.attrs['BoxSize']``;
    periodic; weight, position : column names. Results in :attr:`poles`
    (``corr_<ell>`` columns)."""

    logger = logging.getLogger('SimulationBox3PCF')

    def __init__(self, source, poles, edges, BoxSize=None,
                 periodic=True, weight='Weight', position='Position'):
        require_one_rank(source, 'SimulationBox3PCF')
        if BoxSize is None:
            BoxSize = source.attrs['BoxSize']
        self.attrs = dict(poles=list(poles),
                          edges=np.asarray(edges, 'f8'),
                          BoxSize=np.ones(3) * np.asarray(BoxSize),
                          periodic=periodic)
        pos = source[position].to(torch.float64)
        w = _weights(source, weight, pos.shape[0], pos.device)
        self.poles = self._run(pos, w, edges, poles,
                               BoxSize=self.attrs['BoxSize'],
                               periodic=periodic)


class SurveyData3PCF(Base3PCF):
    """zeta_l(r1, r2) of survey (sky) data, positions from (ra, dec,
    redshift) with ``cosmo``, in the data's bounding box (single-device
    branch of the JAX class)."""

    logger = logging.getLogger('SurveyData3PCF')

    def __init__(self, source, poles, edges, cosmo, ra='RA', dec='DEC',
                 redshift='Redshift', weight='Weight'):
        require_one_rank(source, 'SurveyData3PCF')
        self.attrs = dict(poles=list(poles), edges=np.asarray(edges, 'f8'))
        pos = transform.SkyToCartesian(source[ra], source[dec],
                                       source[redshift],
                                       cosmo).to(torch.float64)
        w = _weights(source, weight, pos.shape[0], pos.device)
        self.poles = self._run(pos, w, edges, poles, BoxSize=None,
                               periodic=False)


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
