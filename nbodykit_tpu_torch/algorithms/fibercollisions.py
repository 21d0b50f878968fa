"""FiberCollisions: a simulation of spectroscopic fiber assignment
(counterpart of ``nbodykit_tpu/algorithms/fibercollisions.py``).

Angular friends-of-friends groups at the collision radius (the port's
:class:`.fof.FOF`, with its kernels on the card, on unit-sphere
positions shifted by 2 in a box of 4, at the chord of the radius), then
the fiber assignment on the host with a seeded ``RandomState`` (Guo et
al. 2012): a pair collides one random member; a larger group removes,
one at a time, the member with the most collisions (ties: the fewest
collisions among its neighbours, then at random).
"""

import logging

import numpy as np
import torch

from ..parallel.runtime import CurrentMesh, require_one_rank
from ..source.catalog.array import ArrayCatalog
from ..transform import SkyToUnitSphere
from ..utils import as_numpy
from .fof import FOF


class FiberCollisions(object):
    """Fiber assignment of (ra, dec) objects.

    ra, dec : arrays or tensors; collision_radius : in degrees (radians
    when ``degrees`` is False); seed : of the assignment's RandomState.

    Results in :attr:`labels`, an ArrayCatalog with Label (the angular
    group, 0 for none), Collided (0/1) and NeighborID (for a collided
    object the index of its nearest uncollided group member, else -1).
    """

    logger = logging.getLogger('FiberCollisions')

    def __init__(self, ra, dec, collision_radius=62. / 60. / 60.,
                 seed=None, degrees=True, comm=None):
        require_one_rank(CurrentMesh.resolve(comm), 'FiberCollisions')
        self._collision_radius_rad = np.radians(
            collision_radius if degrees else np.degrees(collision_radius))
        # the chord of the angular radius
        self._chord = 2 * np.sin(0.5 * self._collision_radius_rad)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        self.attrs = dict(collision_radius=collision_radius, seed=seed)

        pos = SkyToUnitSphere(ra, dec).to(torch.float64)
        # the unit sphere inside a box it does not wrap in
        cat = ArrayCatalog({'Position': pos + 2.0}, device=pos.device,
                           BoxSize=4.0)
        fof = FOF(cat, linking_length=self._chord, nmin=2, absolute=True)
        labels = as_numpy(fof.labels)

        collided, neighbors = self._assign_fibers(as_numpy(pos), labels,
                                                  seed)
        N1 = int((collided == 0).sum())
        N2 = int(collided.sum())
        self.logger.info("population 1 (clean) = %d, population 2 "
                         "(collided) = %d, fraction = %.4f"
                         % (N1, N2, N2 / max(N1 + N2, 1)))
        self.labels = ArrayCatalog(
            {'Label': labels, 'Collided': collided.astype('i4'),
             'NeighborID': neighbors.astype('i4')}, device=pos.device)
        self.labels.attrs.update(self.attrs)

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
