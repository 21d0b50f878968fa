"""LinearMesh: a Gaussian realization of a linear power spectrum
(counterpart of ``nbodykit_tpu/source/mesh/linear.py``; reference
nbodykit/source/mesh/linear.py:6)."""

import numpy as np
import torch

from ...base.mesh import MeshSource
from ... import mockmaker


class LinearMesh(MeshSource):
    """Gaussian field with a given power spectrum.

    Parameters
    ----------
    Plin : callable P(k) -> power, in the box units; called on a tensor
        of |k| (``LinearPower`` interpolates its table on the device)
    BoxSize, Nmesh : geometry
    seed : int — realization seed (the JAX package's white noise)
    unitary_amplitude : bool — fix |delta_k| to its rms
    inverted_phase : bool — flip the phase
    dtype : mesh dtype; comm : the mesh of ranks (default: the ambient
        one); device : 'cuda' (default) or 'cpu'

    With P ranks each rank draws the white noise of its own slab (the
    draw is the one-rank draw, bit for bit) and scales its ky rows; a
    seed drawn for ``seed=None`` is rank 0's.
    """

    def __init__(self, Plin, BoxSize, Nmesh, seed=None,
                 unitary_amplitude=False, inverted_phase=False,
                 dtype='f4', comm=None, device=None):
        self.Plin = Plin
        MeshSource.__init__(self, Nmesh, BoxSize, dtype=dtype,
                            device=device, comm=comm)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
            if self.pm.nproc > 1:
                seed = int(self.pm.comm.broadcast(
                    torch.tensor([seed], device=self.device)))
        self.attrs['seed'] = seed
        self.attrs['unitary_amplitude'] = unitary_amplitude
        self.attrs['inverted_phase'] = inverted_phase
        if hasattr(Plin, 'attrs'):
            self.attrs.update(Plin.attrs)

    def to_complex_field(self):
        """delta_k = whitenoise * sqrt(P(k) / V), zero DC (reference
        recipe: mockmaker.py:7-141)."""
        delta_k, _ = mockmaker.gaussian_complex_fields(
            self.pm, self.Plin, self.attrs['seed'],
            unitary_amplitude=self.attrs['unitary_amplitude'],
            inverted_phase=self.attrs['inverted_phase'])
        return delta_k
