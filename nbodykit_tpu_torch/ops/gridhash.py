"""The grid hash's neighbour traversal (counterpart of
``nbodykit_tpu/ops/gridhash.py``).

:func:`neighbor_offsets` gives the deduplicated neighbour-cell offsets;
:func:`offset_candidates` is the plain traversal every particle
algorithm folds over: per offset, the (start, count) of each query's
neighbour cell by ``searchsorted`` into the sorted cell ids, then the
slots of that cell, yielding ``(j, ok, d, r2)`` with ``j`` indexing the
grid's sorted arrays. The counterpart of the JAX module's host-side
``GridHash`` is :class:`.devicehash.GridHash`, a
:class:`~.devicehash.DeviceGridHash` of f64 positions with ``fold``.
"""

import numpy as np
import torch


def neighbor_offsets(ncell, periodic=True):
    """Neighbour-cell offset triples, deduplicated for tiny grids: with n
    cells along an axis and periodic wrapping, offsets -1 and +1 alias
    to the same cell when n < 3 (and everything aliases at n == 1);
    visiting an aliased offset twice double-counts pairs."""
    per_axis = []
    for n in np.atleast_1d(ncell):
        if periodic:
            if n >= 3:
                per_axis.append((-1, 0, 1))
            elif n == 2:
                per_axis.append((0, 1))
            else:
                per_axis.append((0,))
        else:
            per_axis.append((-1, 0, 1) if n >= 2 else (0,))
    return [(i, j, k) for i in per_axis[0] for j in per_axis[1]
            for k in per_axis[2]]


def neighbor_cells(flat_s, ci, offsets, ncell, periodic):
    """Per neighbour offset, ``(start, count, oob)`` of every query's
    neighbour cell: the cell's slots in the sorted ids ``flat_s`` by
    ``searchsorted``, and whether the offset leaves an open grid (the
    cell is then clipped to the grid and must not be visited). ci :
    (m, 3) int32 query cells; offsets, ncell, periodic : the grid's
    geometry."""
    dev = ci.device
    ncell_t = torch.as_tensor(np.asarray(ncell), dtype=torch.int32,
                              device=dev)
    nc1, nc2 = int(ncell[1]), int(ncell[2])
    for off in offsets:
        nc = ci + torch.as_tensor(off, dtype=torch.int32, device=dev)
        if periodic:
            nc = torch.remainder(nc, ncell_t)
            oob = torch.zeros(nc.shape[0], dtype=torch.bool, device=dev)
        else:
            clipped = torch.minimum(torch.clamp(nc, min=0), ncell_t - 1)
            oob = (nc != clipped).any(dim=-1)
            nc = clipped
        nc = nc.to(flat_s.dtype)
        nflat = (nc[:, 0] * nc1 + nc[:, 1]) * nc2 + nc[:, 2]
        start = torch.searchsorted(flat_s, nflat)
        count = torch.searchsorted(flat_s, nflat, right=True) - start
        yield start, count, oob


def offset_candidates(pos_s, flat_s, p, ci, offsets, ncell, box, periodic,
                      block=None):
    """The plain candidate traversal of the grid hash: a generator over
    (offset, slot) of ``(j, ok, d, r2)`` for every query, one host sync
    per offset (the cells of :func:`neighbor_cells`).

    pos_s : (n, 3) the grid's sorted positions; flat_s : (n,) their
    sorted cell ids (int32/int64); p : (m, 3) query positions (the
    grid's own or not) in the positions' dtype; ci : (m, 3) int32 cell
    coordinates of the queries; offsets, ncell, box, periodic : the
    grid's geometry. ``j`` indexes the sorted arrays (0 where not
    ``ok``); ``ok`` is false where the slot is past the cell or the
    offset leaves an open grid; ``d = pos_s[j] - p``, minimum-imaged
    when periodic; ``r2 = (dx*dx + dy*dy) + dz*dz``. With ``block`` None
    each item is one slot, shapes (m,); else up to ``block`` slots at
    once, shapes (m, s) (and (m, s, 3) for ``d``)."""
    dev = pos_s.device
    box_t = torch.as_tensor(np.asarray(box, 'f8'), dtype=pos_s.dtype,
                            device=dev)
    step = 1 if block is None else int(block)
    for start, count, oob in neighbor_cells(flat_s, ci, offsets, ncell,
                                            periodic):
        kmax = int(torch.where(oob, 0, count).max()) if count.numel() \
            else 0
        for slot in range(0, kmax, step):
            if block is None:
                ok = (slot < count) & ~oob
                j = torch.where(ok, start + slot, 0)
                q = p
            else:
                slots = torch.arange(slot, min(slot + step, kmax),
                                     device=dev)
                ok = (slots[None, :] < count[:, None]) & ~oob[:, None]
                j = torch.where(ok, start[:, None] + slots[None, :], 0)
                q = p[:, None, :]
            d = pos_s[j] - q
            if periodic:
                d = d - torch.round(d / box_t) * box_t
            r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            yield j, ok, d, r2

