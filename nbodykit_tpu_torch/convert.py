"""Carry state across from the JAX package, as numpy arrays.

The system holds no model weights: what crosses is a catalog's columns
and a field. Both cross as numpy arrays (``nbodykit_tpu.utils.as_numpy``
on the JAX side), so this module imports nothing of JAX.
"""

import numpy as np
import torch

from .base.mesh import Field
from .source.catalog.array import ArrayCatalog


def catalog_from_numpy(columns, BoxSize, device=None):
    """An :class:`ArrayCatalog` of numpy ``columns`` (name -> array) on
    ``device``, with ``attrs['BoxSize']`` set."""
    box = np.empty(3, dtype='f8')
    box[:] = BoxSize
    return ArrayCatalog({k: np.asarray(v) for k, v in columns.items()},
                        device=device, BoxSize=box)


def field_from_numpy(array, pm, kind='real'):
    """A :class:`Field` on ``pm``'s device from a numpy array: a real
    (N0, N1, N2) field, or a complex field in the JAX package's
    transposed hermitian layout (N1, N0, N2//2+1), the layout of
    ``pm.r2c`` here too."""
    array = np.asarray(array)
    if kind == 'real':
        shape, dtype = pm.shape_real, pm.torch_dtype
    elif kind == 'complex':
        shape, dtype = pm.shape_complex, pm.complex_dtype
    else:
        raise ValueError("kind must be 'real' or 'complex'")
    if tuple(array.shape) != tuple(shape):
        raise ValueError("a %s field of this mesh has shape %s, got %s"
                         % (kind, shape, array.shape))
    value = torch.as_tensor(np.ascontiguousarray(array)).to(
        device=pm.device, dtype=dtype)
    return Field(value, pm, kind)
