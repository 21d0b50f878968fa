"""FiberCollisions: a simulation of spectroscopic fiber assignment
(counterpart of ``nbodykit_tpu/algorithms/fibercollisions.py``).

Angular friends-of-friends groups at the collision radius (the port's
:class:`.fof.FOF`, with its kernels on the card, on unit-sphere
positions shifted by 2 in a box of 4, at the chord of the radius), then
the fiber assignment on the host with a seeded ``RandomState`` (Guo et
al. 2012): a pair collides one random member; a larger group removes,
one at a time, the member with the most collisions (ties: the fewest
collisions among its neighbours, then at random).

Across ranks (``comm`` of P ranks, ``ra`` and ``dec`` this rank's rows)
FOF runs on its slab branch, and only the grouped rows (label > 0), each
with its global index, label and unit-sphere position, reach every rank;
the assignment then runs alike on every rank, and each keeps its rows.
The slab branch numbers equal-size groups by their least global index,
the one-device FOF by its roots in cell order, so the draws go to the
groups in another order than on one rank, as in the JAX package on a
mesh: the partition is the same, Collided is not.
"""

import logging

import numpy as np
import torch

from ..parallel.runtime import CurrentMesh, mesh_size
from ..source.catalog.array import rows_catalog
from ..transform import SkyToUnitSphere
from ..utils import as_numpy
from .fof import FOF


class FiberCollisions(object):
    """Fiber assignment of (ra, dec) objects.

    ra, dec : arrays or tensors (this rank's rows of ``comm``);
    collision_radius : in degrees (radians when ``degrees`` is False);
    seed : of the assignment's RandomState (drawn, rank 0's, when None);
    comm : the mesh whose rows ``ra`` and ``dec`` are (default: the
    ambient one).

    Results in :attr:`labels`, an ArrayCatalog of this rank's rows with
    Label (the angular group, 0 for none), Collided (0/1) and NeighborID
    (for a collided object the global index of its nearest uncollided
    group member, else -1).
    """

    logger = logging.getLogger('FiberCollisions')

    def __init__(self, ra, dec, collision_radius=62. / 60. / 60.,
                 seed=None, degrees=True, comm=None):
        comm = self.comm = CurrentMesh.resolve(comm)
        ranks = mesh_size(comm) > 1
        self._collision_radius_rad = np.radians(
            collision_radius if degrees else np.degrees(collision_radius))
        # the chord of the angular radius
        self._chord = 2 * np.sin(0.5 * self._collision_radius_rad)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
            if ranks:
                seed = int(comm.broadcast(torch.tensor(
                    [seed], dtype=torch.int64, device=comm.device)))
        self.attrs = dict(collision_radius=collision_radius, seed=seed)

        pos = SkyToUnitSphere(ra, dec).to(torch.float64)
        if ranks:
            pos = pos.to(comm.device)
        # the unit sphere inside a box it does not wrap in
        cat = rows_catalog({'Position': pos + 2.0}, comm, device=pos.device,
                           attrs=dict(BoxSize=4.0))
        fof = FOF(cat, linking_length=self._chord, nmin=2, absolute=True)
        labels, collided, neighbors, N, N2 = self._assign_grouped(
            pos, fof.labels, seed, comm)
        self.logger.info("population 1 (clean) = %d, population 2 "
                         "(collided) = %d, fraction = %.4f"
                         % (N - N2, N2, N2 / max(N, 1)))
        self.labels = rows_catalog(
            {'Label': labels, 'Collided': collided.astype('i4'),
             'NeighborID': neighbors.astype('i4')}, comm, device=pos.device)
        self.labels.attrs.update(self.attrs)

    def _assign_grouped(self, pos, labels, seed, comm):
        """(labels, collided, neighbors) of this rank's rows, then the
        catalog's rows and collided objects (N, N2): the grouped rows of
        every rank (global index, label, position) packed as f64 and
        gathered on every rank (exact below 2**53), the assignment run on
        them alike everywhere, NeighborID mapped to global indices. The
        ungrouped rows take no draw, so on one rank this is the assignment
        of the whole catalog."""
        from ..parallel.domain import allgather_rows, rows_layout
        n = pos.shape[0]
        counts, start = rows_layout(n, comm)
        mine = torch.nonzero(labels > 0).squeeze(1)
        packed = torch.cat([(start + mine).to(torch.float64)[:, None],
                            labels[mine].to(torch.float64)[:, None],
                            pos[mine]], dim=1)
        grouped = as_numpy(allgather_rows(packed, comm))
        gids = grouped[:, 0].astype('i8')
        coll, neigh = self._assign_fibers(grouped[:, 2:],
                                          grouped[:, 1].astype('i8'), seed)
        neigh = np.where(neigh >= 0, gids[np.maximum(neigh, 0)], -1)
        sel = (gids >= start) & (gids < start + n)
        here = gids[sel] - start
        collided = np.zeros(n, dtype='i4')
        neighbors = np.full(n, -1, dtype='i8')
        collided[here] = coll[sel]
        neighbors[here] = neigh[sel]
        return (as_numpy(labels), collided, neighbors, sum(counts),
                int(coll.sum()))

    def _assign_fibers(self, pos, labels, seed):
        """(collided, neighbors) over the groups in increasing label, the
        members of each in increasing index (one stable argsort of the
        labels finds them all)."""
        rng = np.random.RandomState(seed)
        N = len(pos)
        collided = np.zeros(N, dtype='i4')
        neighbors = np.full(N, -1, dtype='i4')
        order = np.argsort(labels, kind='stable')
        uniq, starts, counts = np.unique(labels[order], return_index=True,
                                         return_counts=True)
        for lab, s, c in zip(uniq, starts, counts):
            if lab == 0:
                continue
            members = order[s:s + c]
            if len(members) == 2:
                which = rng.choice(2)
                collided[members[which]] = 1
                neighbors[members[which]] = members[which ^ 1]
                continue
            coll_ids, neigh = self._assign_multiplet(pos[members], rng)
            collided[members[coll_ids]] = 1
            for ci, ni in zip(coll_ids, neigh):
                neighbors[members[ci]] = members[ni]
        return collided, neighbors

    def _assign_multiplet(self, P, rng):
        """Greedy removal in a group of more than two."""
        n = len(P)
        group_ids = list(range(n))
        collided_ids = []
        d = np.sqrt(((P[:, None, :] - P[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        while len(group_ids) > 1:
            sub = d[np.ix_(group_ids, group_ids)]
            collisions = sub <= self._chord
            ncoll = collisions.sum(axis=0)
            if ncoll.max() == 0:
                break
            nother = np.array([ncoll[collisions[:, i]].sum()
                               for i in range(len(group_ids))])
            idx = np.flatnonzero(ncoll == ncoll.max())
            ii = rng.choice(np.flatnonzero(
                nother[idx] == nother[idx].min()))
            collided_index = idx[ii]
            cid = group_ids.pop(collided_index)
            if ncoll[collided_index] > 0:
                collided_ids.append(cid)

        uncollided = [i for i in range(n) if i not in collided_ids]
        neigh = []
        for i in sorted(collided_ids):
            neigh.append(uncollided[int(np.argmin(d[i][uncollided]))])
        return sorted(collided_ids), neigh
