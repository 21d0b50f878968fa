"""Carry state across from the JAX package, as numpy arrays.

The system holds no model weights: what crosses is a catalog's columns,
a field, a PRNG key, the forward model's state (its whitenoise leaf and
linear modes) or a result's saved state. All cross as numpy arrays
(``nbodykit_tpu.utils.as_numpy`` or ``jax.random.key_data`` on the JAX
side), so this module imports nothing of JAX.
"""

import numpy as np
import torch

from .base.mesh import Field
from .source.catalog.array import ArrayCatalog
from .utils import bf16_from_numpy


def catalog_from_numpy(columns, BoxSize, device=None):
    """An :class:`ArrayCatalog` of numpy ``columns`` (name -> array) on
    ``device``, with ``attrs['BoxSize']`` set."""
    box = np.empty(3, dtype='f8')
    box[:] = BoxSize
    return ArrayCatalog({k: np.asarray(v) for k, v in columns.items()},
                        device=device, BoxSize=box)


def tensor_from_numpy(array):
    """A CPU tensor of a numpy array. A JAX bfloat16 array (ml_dtypes,
    recognised by ``dtype.name == 'bfloat16'``) crosses bit for bit as
    ``torch.bfloat16``, through its 16-bit view."""
    array = np.asarray(array)
    if array.dtype.name == 'bfloat16':
        return bf16_from_numpy(array)
    return torch.as_tensor(np.ascontiguousarray(array))


def field_from_numpy(array, pm, kind='real'):
    """A :class:`Field` on ``pm``'s device from a numpy array: a real
    (N0, N1, N2) field, or a complex field in the JAX package's
    transposed hermitian layout (N1, N0, N2//2+1), the layout of
    ``pm.r2c`` here too. A bf16 mesh takes a JAX bfloat16 array bit for
    bit (:func:`tensor_from_numpy`)."""
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
    value = tensor_from_numpy(array).to(device=pm.device, dtype=dtype)
    return Field(value, pm, kind)


def key_from_numpy(raw):
    """The port's threefry key (see :mod:`nbodykit_tpu_torch.rng`) from
    JAX's raw key data, ``np.asarray(jax.random.key_data(k))``: a (2,)
    uint32 array. Draws under it equal JAX's draws under ``k``."""
    raw = np.asarray(raw)
    if raw.shape != (2,) or raw.dtype != np.uint32:
        raise ValueError("JAX threefry key data is a (2,) uint32 array, "
                         "got %s %s" % (raw.dtype, raw.shape))
    return raw.copy()


def _lattice_tensor(array, model, kind):
    lat = model.lattice
    array = np.asarray(array)
    shape = lat.shape_real if kind == 'real' else lat.shape_complex
    if tuple(array.shape) != tuple(shape):
        raise ValueError("the %s state of this model has shape %s, got %s"
                         % (kind, shape, array.shape))
    # this rank's slab: x rows of a real field, ky rows of a complex one
    array = array[lat._rows(shape[0])]
    dtype = lat.torch_dtype if kind == 'real' else lat.complex_dtype
    return tensor_from_numpy(array).to(device=lat.device, dtype=dtype)


def white_from_numpy(array, model):
    """A :class:`~nbodykit_tpu_torch.forward.ForwardModel`'s real
    whitenoise leaf from the whole numpy array (the lattice's real
    shape), as this rank's x-slab on the model's device."""
    return _lattice_tensor(array, model, 'real')


def modes_from_numpy(array, model):
    """A :class:`~nbodykit_tpu_torch.forward.ForwardModel`'s linear modes
    from the whole numpy array, in the transposed hermitian layout (N1,
    N0, N2//2+1) that the JAX package and the port share, as this
    rank's ky-slab on the model's device."""
    return _lattice_tensor(array, model, 'complex')


def bispectrum_from_state(state):
    """A :class:`~nbodykit_tpu_torch.algorithms.bispectrum.Bispectrum`
    from the state of a JAX one (``b.__getstate__()``, its
    BinnedStatistic state and attrs as numpy)."""
    from .algorithms.bispectrum import Bispectrum
    b = object.__new__(Bispectrum)
    b.__setstate__(state)
    return b
