"""ArrayMesh: wrap an array as a MeshSource (counterpart of
``nbodykit_tpu/source/mesh/array.py``; reference
nbodykit/source/mesh/array.py:8). The field is a tensor on the mesh's
device; with P ranks each rank keeps its x-slab of the array, which
every rank passes whole (the JAX package's ``shard_leading``)."""

import numpy as np
import torch

from ...base.mesh import Field, MeshSource
from ...parallel.runtime import shard_leading


class ArrayMesh(MeshSource):
    """A MeshSource from a concrete 3-D real array (numpy or tensor),
    moved to ``device``. ``comm`` is the mesh of ranks (default: the
    ambient one); extra keywords go to :attr:`attrs`."""

    def __init__(self, array, BoxSize, comm=None, device=None, **kwargs):
        if isinstance(array, torch.Tensor):
            dtype = {torch.float32: 'f4', torch.float64: 'f8'}.get(
                array.dtype)
            if dtype is None:
                raise ValueError("ArrayMesh takes an f4 or f8 array, got "
                                 "%s" % array.dtype)
        else:
            array = np.asarray(array)
            dtype = array.dtype.str
        if array.ndim != 3:
            raise ValueError("ArrayMesh expects a 3-D array")
        MeshSource.__init__(self, tuple(array.shape), BoxSize, dtype=dtype,
                            device=device, comm=comm)
        self.attrs.update(kwargs)
        value = shard_leading(self.pm.comm if self.pm.nproc > 1 else None,
                              torch.as_tensor(array))
        self._value = value.to(device=self.device,
                               dtype=self.pm.torch_dtype)

    def to_real_field(self):
        return Field(self._value, self.pm, 'real')
