"""Neighbour-cell offsets of the grid hash (counterpart of
``nbodykit_tpu/ops/gridhash.py``, whose host-side ``GridHash`` serves
the particle algorithms and is not ported yet)."""

import numpy as np


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
