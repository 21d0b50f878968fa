"""SubVolumesCatalog: a catalog re-ordered into spatial subvolumes
(counterpart of ``nbodykit_tpu/source/catalog/subvolumes.py``).

Reference: ``nbodykit/source/catalog/subvolumes.py:6`` — a domain-
decomposed copy of a catalog (there via pmesh.domain). Here the
particles are sorted by their subvolume index, so each subvolume's
particles are contiguous; the sort is stable, as JAX's argsort is, so
ties keep catalog order.
"""

import numpy as np
import torch

from .array import ArrayCatalog
from ...parallel.runtime import require_one_rank


class SubVolumesCatalog(ArrayCatalog):
    """A catalog sorted into a (nx, ny, nz) grid of subvolumes, on the
    source catalog's device.

    Adds a ``SubVolumeIndex`` column with the flat subvolume id (int64).
    """

    def __init__(self, source, domain=None, position='Position',
                 columns=None):
        if domain is None:
            domain = [1, 1, 1]
        domain = np.asarray(domain, dtype='i8')
        # the cell indices are int32, as in the JAX package
        if int(np.prod(domain)) - 1 > np.iinfo(np.int32).max:
            raise ValueError('subvolume grid %s overflows int32 flat '
                             'indexing' % (tuple(domain),))
        dev = source.device
        box = np.ones(3) * np.asarray(source.attrs['BoxSize'])
        pos = torch.as_tensor(source[position], device=dev)
        cell = torch.as_tensor(box / domain, device=dev)
        hi = torch.as_tensor(domain - 1, dtype=torch.int32, device=dev)
        idx = torch.minimum(torch.clamp(
            (pos / cell).to(torch.int32), min=0), hi).long()
        flat = (idx[:, 0] * int(domain[1]) + idx[:, 1]) * int(domain[2]) \
            + idx[:, 2]
        order = torch.argsort(flat, stable=True)
        cols = columns or source.columns
        data = {c: source[c][order] for c in cols}
        data['SubVolumeIndex'] = flat[order]
        ArrayCatalog.__init__(self, data, device=dev, **source.attrs)
        require_one_rank(self, 'SubVolumesCatalog')
        self.attrs['domain'] = domain
