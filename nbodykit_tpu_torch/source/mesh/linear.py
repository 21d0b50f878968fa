"""LinearMesh: a Gaussian realization of a linear power spectrum
(counterpart of ``nbodykit_tpu/source/mesh/linear.py``; reference
nbodykit/source/mesh/linear.py:6)."""

import numpy as np

from ...base.mesh import MeshSource
from ... import mockmaker
from ...parallel.runtime import require_one_rank


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
    dtype : mesh dtype; device : 'cuda' (default) or 'cpu'
    """

    def __init__(self, Plin, BoxSize, Nmesh, seed=None,
                 unitary_amplitude=False, inverted_phase=False,
                 dtype='f4', device=None):
        self.Plin = Plin
        MeshSource.__init__(self, Nmesh, BoxSize, dtype=dtype,
                            device=device)
        require_one_rank(self, 'LinearMesh')
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
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
