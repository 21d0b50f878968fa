"""CylindricalGroups: the cylinder-based group finder (counterpart of
``nbodykit_tpu/algorithms/cgm.py``).

Objects are ranked (e.g. by mass); an object is a satellite iff a
higher-ranked central lies in the cylinder of radius ``rperp`` and half
height ``rpar`` around it along the line of sight, and then belongs to
the highest-ranked such central. That greedy recursion is a fixpoint on
the rank order, reached by Jacobi rounds: every round is one fold over
the grid hash (:meth:`..ops.devicehash.DeviceGridHash.fold`, plain
torch on the positions' device), from all-central to no change. Ranks
are unique and the test ``rank[j] < best`` strict, so every round gives
the JAX package's round exactly.

Across ranks (a catalog with a ``comm`` of P ranks) the rank order is
the JAX package's global lexsort of the gathered ``rankby`` keys, and
the rounds run domain-decomposed where the cylinder's radius fits a
slab (:func:`_cgm_rounds_dist`): the particles and their ghosts go to
the owners of balanced x-slabs once, and each round ships the central
flags along that frozen route, sweeps every copy a rank holds, and
sends the owner copies' verdicts back to their rows, until no flag
changes on any rank. A wider radius gathers the catalog on every rank.
"""

import logging

import numpy as np
import torch

from ..ops.devicehash import DeviceGridHash
from ..source.catalog.array import rows_catalog
from ..utils import as_numpy
from ..parallel.runtime import mesh_size

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


def _open_box(pos, mesh):
    """(pos shifted by its least corner, the non-periodic work box): the
    data's extent plus 1e-3, over every rank's positions."""
    from ..parallel.domain import global_bounds
    lo, hi = global_bounds(pos, mesh)
    lo, hi = lo.to(pos.dtype), hi.to(pos.dtype)
    return pos - lo, (hi - lo).cpu().numpy() + 1e-3


def _cgm_rounds(pos, rank, work, rperp, rpar, los, periodic):
    """(satellite mask, haloid, rounds) in input order, tensors, on one
    device; haloid -1 for centrals, else the central's index."""
    rmax = float(np.sqrt(rperp ** 2 + rpar ** 2))
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
    return sat, haloid, rounds


def _cgm_rounds_dist(pos, rank, work, rperp, rpar, los, periodic, mesh):
    """(satellite mask, haloid, rounds) of this rank's rows across the
    ranks of ``mesh`` (the JAX package's routed rounds): haloid is the
    central's global index.

    1. Route once (:func:`..parallel.domain.slab_route`, ``'both'`` at
       sqrt(rperp^2 + rpar^2), balanced slabs) with the global ids,
       ranks and owner flags; one grid over the copies a rank holds.
    2. Each round ships the central flags along the frozen route,
       sweeps the local grid, and reduces the owner copies' satellite
       flags into their rows (:func:`..parallel.domain.scatter_reduce_by_index`,
       'max').
    3. An ``all_reduce`` of 'changed' ends the rounds on every rank
       together."""
    from ..parallel.domain import (rows_layout, scatter_reduce_by_index,
                                   slab_route)
    rmax = float(np.sqrt(rperp ** 2 + rpar ** 2))
    n = pos.shape[0]
    dev = pos.device
    counts, start = rows_layout(n, mesh)
    N = sum(counts)
    route, f, _ = slab_route(pos, work, rmax, mesh, ghosts='both',
                             periodic=periodic, balance=True)
    gid = start + torch.arange(n, dtype=torch.int64, device=dev)
    own = torch.zeros(f * n, dtype=torch.bool, device=dev)
    own[:n] = True
    (pos_r, gid_r, rank_r, own_r), ok, _ = route.exchange(
        [pos, gid, rank, own])
    got = torch.nonzero(ok).squeeze(1)
    # the copies this rank holds, in the order of its grid's slots (a
    # rank that holds none sweeps nothing)
    grid = DeviceGridHash(pos_r[got].contiguous(), work, rmax,
                          periodic=periodic) if got.shape[0] else None
    order = got[grid.order] if grid is not None else got
    gid_s, rank_s, own_s = gid_r[order], rank_r[order], own_r[order]
    central = torch.ones(n, dtype=torch.bool, device=dev)
    bestj = torch.empty(0, dtype=torch.int64, device=dev)
    rounds = 0
    while True:
        (central_r,), _, _ = route.exchange([central])
        if grid is not None:
            bestj = _cylinder_sweep(grid, rank_s, central_r[order], los,
                                    rperp, rpar)
        sat = scatter_reduce_by_index(
            gid_s, (bestj >= 0).to(torch.int32), N, mesh, op='max',
            valid=own_s, counts=counts) > 0
        rounds += 1
        changed = mesh.all_reduce(
            (sat == central).any().to(torch.int32).reshape(1), 'max')
        central = ~sat
        if not int(changed):
            break
    haloid_s = torch.where(bestj >= 0, gid_s[torch.clamp(bestj, min=0)], -1)
    haloid = scatter_reduce_by_index(gid_s, haloid_s, N, mesh, op='max',
                                     valid=own_s, counts=counts)
    return sat, torch.where(sat, haloid, -1), rounds


def _cgm_classify(pos, rank, box, rperp, rpar, los, periodic, mesh=None):
    """(satellite mask, haloid, rounds, branch) for this rank's rows,
    numpy; haloid -1 for centrals, else the central's (global) index.
    ``rank``: this rank's rows of the (N,) int32 global rank, 0 the
    highest priority; ``box`` None: non-periodic in the data's extent
    plus 1e-3."""
    from ..parallel.domain import allgather_rows, rows_layout
    rmax = float(np.sqrt(rperp ** 2 + rpar ** 2))
    if box is None:
        pos, work = _open_box(pos, mesh)
        periodic = False
    else:
        work = np.ones(3) * np.asarray(box, dtype='f8')
    nproc = mesh_size(mesh)
    if nproc > 1 and rmax <= work[0] / nproc:
        sat, haloid, rounds = _cgm_rounds_dist(pos, rank, work, rperp, rpar,
                                               los, periodic, mesh)
        branch = 'slab'
    elif nproc > 1:
        counts, start = rows_layout(pos.shape[0], mesh)
        sat, haloid, rounds = _cgm_rounds(
            allgather_rows(pos, mesh), allgather_rows(rank, mesh), work,
            rperp, rpar, los, periodic)
        rows = slice(start, start + counts[mesh.rank])
        sat, haloid = sat[rows], haloid[rows]
        branch = 'gathered'
    else:
        sat, haloid, rounds = _cgm_rounds(pos, rank, work, rperp, rpar, los,
                                          periodic)
        branch = 'one_rank'
    return as_numpy(sat), as_numpy(haloid), rounds, branch


class CylindricalGroups(object):
    """Cylindrical groups (Okumura et al. 2017) of a catalog, on its
    device.

    source; rankby : column name(s), descending priority; rperp, rpar :
    the cylinder; flat_sky_los : unit vector (None: the z axis);
    periodic; BoxSize (default ``source.attrs['BoxSize']``).

    Results in :attr:`groups`, an ArrayCatalog of this rank's rows with
    ``cgm_type`` (0 central, 1 satellite), ``cgm_haloid`` (the central's
    global index for a satellite, else -1) and ``num_cgm_sats`` (for a
    central); :attr:`rounds`, the Jacobi rounds to the fixpoint;
    :attr:`branch`, 'one_rank', 'slab' or 'gathered'.
    """

    logger = logging.getLogger('CylindricalGroups')

    def __init__(self, source, rankby, rperp, rpar, flat_sky_los=None,
                 periodic=True, BoxSize=None):
        from ..parallel.domain import (allgather_rows, rows_layout,
                                       scatter_reduce_by_index)
        if rankby is None:
            rankby = []
        if isinstance(rankby, str):
            rankby = [rankby]
        for col in rankby:
            if col not in source:
                raise ValueError("rankby column %r missing" % col)
        self.comm = source.comm
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

        n = len(source)
        counts, start = rows_layout(n, self.comm)
        N = sum(counts)
        # descending rank order of the whole keys, on the host (small 1-D
        # keys, gathered across ranks), as the JAX package lexsorts them
        if rankby:
            keys = tuple(as_numpy(allgather_rows(source[c], self.comm))
                         for c in reversed(rankby))
            order = np.lexsort(keys)[::-1]
        else:
            order = np.arange(N)
        rank_of = np.empty(N, dtype='i4')
        rank_of[order] = np.arange(N, dtype='i4')

        pos = source['Position']
        sat, haloid, self.rounds, self.branch = _cgm_classify(
            pos, torch.as_tensor(rank_of[start:start + n], device=pos.device),
            box, rperp, rpar, flat_sky_los, self.attrs['periodic'],
            self.comm)
        self.logger.info("CGM branch %s, %d rounds", self.branch,
                         self.rounds)

        hid = torch.as_tensor(haloid[sat], dtype=torch.int64,
                              device=pos.device)
        nsat = as_numpy(scatter_reduce_by_index(
            hid, torch.ones_like(hid), N, self.comm, op='add',
            counts=counts))
        cgm_type = np.zeros(n, dtype='i4')
        cgm_type[sat] = 1
        cgm_haloid = np.where(sat, haloid, -1).astype('i8')
        self.groups = rows_catalog(
            {'cgm_type': cgm_type, 'cgm_haloid': cgm_haloid,
             'num_cgm_sats': nsat}, self.comm, device=source.device)
        self.groups.attrs.update(self.attrs)
