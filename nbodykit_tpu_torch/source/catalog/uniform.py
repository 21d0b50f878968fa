"""Random and uniform catalogs (counterpart of
``nbodykit_tpu/source/catalog/uniform.py``)."""

import numpy as np
import torch

from ...base.catalog import CatalogSource, column
from ...parallel.runtime import CurrentMesh, row_range
from ...rng import DistributedRNG
from ...utils import torch_dtype, working_dtype


class RandomCatalog(CatalogSource):
    """A catalog whose columns are drawn from the seeded threefry
    generator exposed as :attr:`rng` (the JAX package's draws, call for
    call). ``csize`` is the global size; with a ``comm`` of P ranks each
    rank holds and draws its own rows, bit for bit those rows of the
    one-rank catalog."""

    def __init__(self, csize, seed=None, device=None, comm=None):
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        if csize == 0:
            raise ValueError("no random particles generated!")
        comm = CurrentMesh.resolve(comm)
        start, stop = (0, csize) if comm is None else \
            row_range(csize, comm.size, comm.rank)
        CatalogSource.__init__(self, stop - start, device=device, comm=comm)
        self.attrs['seed'] = seed
        self._rng = DistributedRNG(seed, csize, device=self.device,
                                   comm=self.comm)

    @property
    def rng(self):
        return self._rng

    def __repr__(self):
        return "RandomCatalog(size=%d, seed=%s)" % (
            self.size, self.attrs['seed'])


class UniformCatalog(RandomCatalog):
    """Uniformly distributed ``Position`` and ``Velocity`` in a box.

    The count N is Poisson(nbar * volume) drawn by the same numpy call
    as the JAX package. Positions, then velocities, are drawn from
    ``rng`` and equal the JAX package's bit for bit, at f8 and f4 (the
    f4 draws are scaled by the f8 box before they are rounded, as
    there).
    """

    def __init__(self, nbar, BoxSize, seed=None, dtype='f8', device=None,
                 comm=None):
        _BoxSize = np.empty(3, dtype='f8')
        _BoxSize[:] = BoxSize
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        N = int(np.random.RandomState(seed).poisson(
            nbar * np.prod(_BoxSize)))
        if N == 0:
            raise ValueError("no uniform particles generated; "
                             "increase nbar")
        RandomCatalog.__init__(self, N, seed=seed, device=device, comm=comm)
        self.attrs['BoxSize'] = _BoxSize
        self.attrs['nbar'] = nbar

        wdt = working_dtype(dtype)
        tdt = torch_dtype(wdt)
        box = torch.as_tensor(_BoxSize, dtype=torch.float64,
                              device=self.device)
        u = self.rng.uniform(itemshape=(3,), dtype=wdt)
        self._pos = (u.double() * box).to(tdt)
        u = self.rng.uniform(itemshape=(3,), dtype=wdt)
        self._vel = (u.double() * box * 0.01).to(tdt)

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
