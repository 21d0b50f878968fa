"""KDDensity: a per-particle density proxy (counterpart of
``nbodykit_tpu/algorithms/kdtree.py``), on the catalog's device; the JAX
package's domain-decomposed ``_kdd_counts_dist`` waits for the
multi-GPU port.

The proxy is the number of particles within a kernel radius (the
particle itself and coincident duplicates included) over the kernel's
volume. The neighbours are the link count of the FOF
(:func:`..ops.fof_cuda.fof_link_count`: the ``fof_link_count`` kernel
on the card, its plain version on the CPU) at a linking length of the
kernel radius, on an f64 grid of the positions, plus one for the
particle itself: the JAX body's ``valid & (r2 <= r^2)`` over the same
candidates, with the same f64 arithmetic.
"""

import logging

import numpy as np
import torch

from ..ops.fof_cuda import fof_link_count
from ..ops.devicehash import GridHash
from ..parallel.runtime import require_one_rank


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


class KDDensity(object):
    """A density proxy for every object of a catalog.

    source : catalog with Position and attrs['BoxSize']; margin : the
    kernel radius in units of the mean inter-particle separation.

    Attributes: ``density``, (N,) f64 tensor on the catalog's device:
    neighbours within the kernel (the particle included) over the
    kernel volume.
    """

    logger = logging.getLogger('KDDensity')

    def __init__(self, source, margin=1.0):
        require_one_rank(source, 'KDDensity')
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
        self.density = neighbor_counts(pos, BoxSize, r).to(
            torch.float64) / vol
