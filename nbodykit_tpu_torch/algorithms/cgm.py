"""CylindricalGroups: the cylinder-based group finder (counterpart of
``nbodykit_tpu/algorithms/cgm.py``), on one device; the JAX package's
routed, domain-decomposed rounds wait for the multi-GPU port.

Objects are ranked (e.g. by mass); an object is a satellite iff a
higher-ranked central lies in the cylinder of radius ``rperp`` and half
height ``rpar`` around it along the line of sight, and then belongs to
the highest-ranked such central. That greedy recursion is a fixpoint on
the rank order, reached by Jacobi rounds: every round is one fold over
the grid hash (:meth:`..ops.devicehash.DeviceGridHash.fold`, plain
torch on the positions' device), from all-central to no change. Ranks
are unique and the test ``rank[j] < best`` strict, so every round gives
the JAX package's round exactly.
"""

import logging

import numpy as np
import torch

from ..ops.devicehash import DeviceGridHash
from ..source.catalog.array import ArrayCatalog
from ..utils import as_numpy
from ..parallel.runtime import require_one_rank

# slots of one neighbour offset a step of the fold
FOLD_BLOCK = 8
INT32_MAX = 2 ** 31 - 1


def _cylinder_sweep(grid, rank_s, central_s, los, rperp, rpar):
    """One Jacobi round on the sorted slots: per query, the slot of the
    highest-ranked (smallest rank) central above it in the cylinder, or
    -1 (the reference takes the first central in rank order, not the
    nearest)."""
    pos = grid.pos_s
    ci = grid.cell_of(pos)
    rp2 = torch.tensor(float(rperp) ** 2, dtype=pos.dtype, device=pos.device)
    rpar_t = torch.tensor(float(rpar), dtype=pos.dtype, device=pos.device)
    los_t = torch.as_tensor(np.asarray(los, 'f8'), dtype=pos.dtype,
                            device=pos.device)
    n = pos.shape[0]
    rank_q = rank_s[:, None]

    def body(carry, j, valid, d, r2):
        bestrank, bestj = carry
        dpar = torch.abs((d[..., 0] * los_t[0] + d[..., 1] * los_t[1])
                         + d[..., 2] * los_t[2])
        dperp2 = torch.clamp(r2 - dpar * dpar, min=0.0)
        rj = rank_s[j]
        ok = (valid & central_s[j] & (rj < rank_q) & (dpar <= rpar_t)
              & (dperp2 <= rp2))
        cand = torch.where(ok, rj, INT32_MAX)
        r_min, arg = cand.min(dim=1)
        j_min = torch.gather(j, 1, arg[:, None])[:, 0]
        better = r_min < bestrank
        return (torch.where(better, r_min, bestrank),
                torch.where(better, j_min.to(torch.int64), bestj))

    init = (torch.full((n,), INT32_MAX, dtype=rank_s.dtype,
                       device=pos.device),
            torch.full((n,), -1, dtype=torch.int64, device=pos.device))
    _, bestj = grid.fold(pos, ci, body, init, block=FOLD_BLOCK)
    return bestj


def _cgm_classify(pos, rank, box, rperp, rpar, los, periodic):
    """(satellite mask, haloid) in input order, numpy; haloid -1 for
    centrals. ``rank``: (N,) int32 tensor, 0 the highest priority;
    ``box`` None: non-periodic in the data's extent plus 1e-3."""
    rmax = float(np.sqrt(rperp ** 2 + rpar ** 2))
    if box is None:
        lo = pos.min(dim=0).values
        work = (pos.max(dim=0).values - lo).cpu().numpy() + 1e-3
        pos = pos - lo
        periodic = False
    else:
        work = np.ones(3) * np.asarray(box, dtype='f8')
    N = pos.shape[0]
    grid = DeviceGridHash(pos, work, rmax, periodic=periodic)
    rank_s = rank[grid.order]
    central = torch.ones(N, dtype=torch.bool, device=pos.device)
    rounds = 0
    while True:
        bestj = _cylinder_sweep(grid, rank_s, central, los, rperp, rpar)
        rounds += 1
        central_new = bestj < 0
        if bool((central_new == central).all()):
            break
        central = central_new
    order = grid.order
    haloid_s = torch.where(bestj >= 0, order[torch.clamp(bestj, min=0)], -1)
    sat = torch.zeros(N, dtype=torch.bool, device=pos.device)
    sat[order] = bestj >= 0
    haloid = torch.full((N,), -1, dtype=torch.int64, device=pos.device)
    haloid[order] = haloid_s
    return as_numpy(sat), as_numpy(haloid).astype('i4'), rounds


class CylindricalGroups(object):
    """Cylindrical groups (Okumura et al. 2017) of a catalog, on its
    device.

    source; rankby : column name(s), descending priority; rperp, rpar :
    the cylinder; flat_sky_los : unit vector (None: the z axis);
    periodic; BoxSize (default ``source.attrs['BoxSize']``).

    Results in :attr:`groups`, an ArrayCatalog with ``cgm_type`` (0
    central, 1 satellite), ``cgm_haloid`` (the central's index for a
    satellite, else -1) and ``num_cgm_sats`` (for a central);
    :attr:`rounds`, the Jacobi rounds to the fixpoint.
    """

    logger = logging.getLogger('CylindricalGroups')

    def __init__(self, source, rankby, rperp, rpar, flat_sky_los=None,
                 periodic=True, BoxSize=None):
        require_one_rank(source, 'CylindricalGroups')
        if rankby is None:
            rankby = []
        if isinstance(rankby, str):
            rankby = [rankby]
        for col in rankby:
            if col not in source:
                raise ValueError("rankby column %r missing" % col)
        if BoxSize is None:
            BoxSize = source.attrs.get('BoxSize', None)
        if periodic and BoxSize is None:
            raise ValueError("periodic grouping requires a BoxSize")
        if flat_sky_los is None:
            flat_sky_los = [0, 0, 1]
        flat_sky_los = np.asarray(flat_sky_los, dtype='f8')
        self.attrs = dict(rperp=rperp, rpar=rpar, periodic=periodic,
                          flat_sky_los=flat_sky_los, rankby=rankby)
        box = None
        if BoxSize is not None:
            box = np.ones(3) * np.asarray(BoxSize)
            self.attrs['BoxSize'] = box

        N = source.csize
        # descending rank order on the host (small 1-D keys)
        if rankby:
            keys = tuple(as_numpy(source[c]) for c in reversed(rankby))
            order = np.lexsort(keys)[::-1]
        else:
            order = np.arange(N)
        rank_of = np.empty(N, dtype='i4')
        rank_of[order] = np.arange(N, dtype='i4')

        pos = source['Position']
        sat, haloid, self.rounds = _cgm_classify(
            pos, torch.as_tensor(rank_of, device=pos.device), box, rperp,
            rpar, flat_sky_los, self.attrs['periodic'])

        nsat = np.bincount(haloid[sat], minlength=N).astype('i8')
        cgm_type = np.zeros(N, dtype='i4')
        cgm_type[sat] = 1
        cgm_haloid = np.where(sat, haloid, -1).astype('i8')
        self.groups = ArrayCatalog(
            {'cgm_type': cgm_type, 'cgm_haloid': cgm_haloid,
             'num_cgm_sats': nsat}, device=source.device)
        self.groups.attrs.update(self.attrs)
