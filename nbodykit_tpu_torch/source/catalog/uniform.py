"""Uniform catalogs (counterpart of
``nbodykit_tpu/source/catalog/uniform.py``)."""

import numpy as np
import torch

from ...base.catalog import CatalogSource, column
from ...utils import torch_dtype


class UniformCatalog(CatalogSource):
    """Uniformly distributed ``Position`` and ``Velocity`` in a box.

    The count N is Poisson(nbar * volume) drawn by the same numpy call
    as the JAX package, so N matches it for the same seed. Positions and
    velocities are drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``: they do NOT equal the JAX package's threefry draws
    for that seed, only their distribution does.
    """

    def __init__(self, nbar, BoxSize, seed=None, dtype='f8', device=None):
        _BoxSize = np.empty(3, dtype='f8')
        _BoxSize[:] = BoxSize
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        N = int(np.random.RandomState(seed).poisson(
            nbar * np.prod(_BoxSize)))
        if N == 0:
            raise ValueError("no uniform particles generated; "
                             "increase nbar")
        CatalogSource.__init__(self, N, device=device)
        self.attrs['seed'] = seed
        self.attrs['BoxSize'] = _BoxSize
        self.attrs['nbar'] = nbar

        tdt = torch_dtype(dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        box = torch.as_tensor(_BoxSize, dtype=tdt, device=self.device)
        self._pos = torch.rand((N, 3), generator=gen, dtype=tdt,
                               device=self.device) * box
        self._vel = torch.rand((N, 3), generator=gen, dtype=tdt,
                               device=self.device) * box * 0.01

    def __repr__(self):
        return "UniformCatalog(size=%d, seed=%s)" % (
            self.size, self.attrs['seed'])

    @column
    def Position(self):
        """Uniform positions in [0, BoxSize)."""
        return self._pos

    @column
    def Velocity(self):
        """Uniform velocities in [0, 0.01*BoxSize)."""
        return self._vel
