"""ArrayMesh: wrap an array as a MeshSource (counterpart of
``nbodykit_tpu/source/mesh/array.py``; reference
nbodykit/source/mesh/array.py:8). One device, no sharding: the field is
a tensor on the mesh's device."""

import numpy as np
import torch

from ...base.mesh import Field, MeshSource
from ...parallel.runtime import require_one_rank


class ArrayMesh(MeshSource):
    """A MeshSource from a concrete 3-D real array (numpy or tensor),
    moved to ``device``; extra keywords go to :attr:`attrs`."""

    def __init__(self, array, BoxSize, device=None, **kwargs):
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
                            device=device)
        require_one_rank(self, 'ArrayMesh')
        self.attrs.update(kwargs)
        self._value = torch.as_tensor(array).to(device=self.device,
                                                dtype=self.pm.torch_dtype)

    def to_real_field(self):
        return Field(self._value, self.pm, 'real')
