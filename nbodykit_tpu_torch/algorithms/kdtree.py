"""KDDensity: a per-particle density proxy (counterpart of
``nbodykit_tpu/algorithms/kdtree.py``), on the catalog's device.

The proxy is the number of particles within a kernel radius (the
particle itself and coincident duplicates included) over the kernel's
volume. The neighbours are the link count of the FOF
(:func:`..ops.fof_cuda.fof_link_count`: the ``fof_link_count`` kernel
on the card, its plain version on the CPU) at a linking length of the
kernel radius, on an f64 grid of the positions, plus one for the
particle itself: the JAX body's ``valid & (r2 <= r^2)`` over the same
candidates, with the same f64 arithmetic.

Across ranks, when the kernel radius fits a slab, the count is
domain-decomposed (:func:`_kdd_counts_dist`); a wider radius gathers the
catalog on every rank, as the JAX package does.
"""

import logging

import numpy as np
import torch

from ..ops.fof_cuda import fof_link_count
from ..ops.devicehash import GridHash
from ..parallel.runtime import mesh_size


def neighbor_counts(pos, box, r, periodic=True):
    """(N,) int64 in input order: the points within ``r`` of each, itself
    included, for f64 positions in [0, box)."""
    grid = GridHash(pos, box, r, periodic=periodic)
    ci_s = grid.cell_of(grid.pos_s).contiguous()
    links = fof_link_count(grid.pos_s, ci_s, grid.flat_s, grid.valid_s,
                           grid.columns(), grid.offsets, grid.ncell_np,
                           grid.box_np, float(r) * float(r), grid.periodic)
    counts = torch.empty(pos.shape[0], dtype=torch.int64, device=pos.device)
    counts[grid.order] = links.to(torch.int64) + 1
    return counts


def _kdd_counts_dist(pos, box, r, mesh, periodic=True):
    """(n,) int64 neighbour counts within ``r`` (the particle included)
    of this rank's rows, domain-decomposed: the particles and their
    ghosts within ``r`` of either slab face go to the owners of
    balanced x-slabs (:func:`..parallel.domain.slab_route`,
    ``'both'``), so every owner copy has all its neighbours on its rank;
    each rank counts every copy it holds (:func:`neighbor_counts`), and
    only the owner copies' counts go back to their particles' rows
    (:func:`..parallel.domain.scatter_reduce_by_index`, one entry a
    particle). pos : f64, in [0, box)."""
    from ..parallel.domain import (rows_layout, scatter_reduce_by_index,
                                   slab_route)
    n = pos.shape[0]
    dev = pos.device
    box = np.asarray(box, dtype='f8')
    counts, start = rows_layout(n, mesh)
    route, f, _ = slab_route(pos, box, r, mesh, ghosts='both',
                             periodic=periodic, balance=True)
    gid = start + torch.arange(n, dtype=torch.int64, device=dev)
    own = torch.zeros(f * n, dtype=torch.bool, device=dev)
    own[:n] = True
    (pos_r, gid_r, own_r), ok, _ = route.exchange([pos, gid, own])
    got = torch.nonzero(ok).squeeze(1)
    pos_r, gid_r, own_r = pos_r[got].contiguous(), gid_r[got], own_r[got]
    local = neighbor_counts(pos_r, box, r, periodic=periodic) \
        if pos_r.shape[0] else gid_r
    return scatter_reduce_by_index(gid_r, local, sum(counts), mesh,
                                   op='add', valid=own_r, counts=counts)


class KDDensity(object):
    """A density proxy for every object of a catalog.

    source : catalog with Position and attrs['BoxSize']; margin : the
    kernel radius in units of the mean inter-particle separation.

    Attributes: ``density``, (N,) f64 tensor on the catalog's device
    (this rank's rows): neighbours within the kernel (the particle
    included) over the kernel volume; ``branch``, 'one_rank', 'slab' or
    'gathered' (across ranks, a radius wider than a slab).
    """

    logger = logging.getLogger('KDDensity')

    def __init__(self, source, margin=1.0):
        if 'Position' not in source:
            raise ValueError("source needs a Position column")
        BoxSize = np.ones(3) * np.asarray(source.attrs['BoxSize'],
                                          dtype='f8')
        self.attrs = dict(margin=margin, BoxSize=BoxSize)
        N = source.csize
        mean_sep = (np.prod(BoxSize) / N) ** (1.0 / 3)
        r = margin * mean_sep
        self.attrs['kernel_radius'] = r
        vol = 4.0 / 3 * np.pi * r ** 3
        pos = source['Position'].to(torch.float64)
        comm = source.comm
        nproc = mesh_size(comm)
        if nproc > 1 and r <= BoxSize[0] / nproc:
            self.branch = 'slab'
            counts = _kdd_counts_dist(pos, BoxSize, r, comm)
        elif nproc > 1:
            from ..parallel.domain import allgather_rows, rows_layout
            self.branch = 'gathered'
            rows, start = rows_layout(pos.shape[0], comm)
            counts = neighbor_counts(allgather_rows(pos, comm), BoxSize,
                                     r)[start:start + rows[comm.rank]]
        else:
            self.branch = 'one_rank'
            counts = neighbor_counts(pos, BoxSize, r)
        self.logger.info("KDDensity branch %s", self.branch)
        self.density = counts.to(torch.float64) / vol
