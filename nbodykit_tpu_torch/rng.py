"""Seeded draws equal to the JAX package's (counterpart of
``nbodykit_tpu/rng.py``).

The JAX package draws with ``jax.random``'s threefry2x32 under the
partitionable setting: element i of a draw is the hash of the counter
i (hi word, lo word) under the draw's key, so a draw depends only on
(seed, call order, global shape), never on the device layout. This
module computes the same values:

- keys are (2,) uint32 numpy arrays on the host, JAX's raw key data
  (``jax.random.key_data``); ``key``, ``fold_in`` and ``split`` hash
  a counter or two on the host;
- ``random_bits``, ``uniform`` and ``normal`` go through
  :func:`ops.threefry_cuda.threefry_fill`, ``poisson`` through
  :func:`ops.threefry_cuda.poisson_threefry`: the CUDA kernels for a
  CUDA device, their plain versions on the CPU.

Bits, uniforms and Poisson counts (given the same lam) equal JAX's bit
for bit. Normals use XLA's ``erf_inv`` arithmetic, but torch's
``log1p`` is not XLA's: f32 normals differ from JAX's by at most a few
ulp, f64 normals by ~1e-15.
"""

import numpy as np
import torch

from . import resolve_device
from .ops.threefry_cuda import (M32, fma, poisson_threefry, split_key,
                                threefry2x32, threefry_fill)
from .utils import torch_dtype, working_dtype


def key(seed):
    """JAX's ``random.key(seed)`` as raw key data: the 64-bit seed's hi
    and lo words (a 32-bit seed has hi word 0)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 64:
        raise ValueError("a seed is a 64-bit integer, got %d" % seed)
    seed &= 2 ** 64 - 1
    return np.array([seed >> 32, seed & M32], dtype=np.uint32)


def _words(key):
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError("a key is a (2,) uint32 array, got %s %s"
                         % (key.dtype, key.shape))
    return int(key[0]), int(key[1])


def threefry_2x32(key, count):
    """JAX's ``prng.threefry_2x32``: the flat count array (padded with
    one 0 when its length is odd) is cut into halves that are hashed as
    the two counter words. ``count`` is an array of uint32 values;
    returns a uint32 numpy array of its shape."""
    k0, k1 = _words(key)
    flat = np.asarray(count, dtype=np.uint32).reshape(-1).astype(np.int64)
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, [0]])
    half = flat.size // 2
    x0, x1 = threefry2x32(k0, k1, torch.from_numpy(flat[:half]),
                          torch.from_numpy(flat[half:]))
    out = torch.cat([x0, x1]).numpy()
    if odd:
        out = out[:-1]
    return out.astype(np.uint32).reshape(np.shape(count))


def fold_in(key, data):
    """JAX's ``random.fold_in``: the hash of the count [0, data]."""
    data = int(data)
    if not 0 <= data <= M32:
        raise ValueError("fold_in data is a uint32, got %d" % data)
    return threefry_2x32(key, np.array([0, data], dtype=np.uint32))


def split(key, num=2):
    """JAX's ``random.split`` (foldlike): (num, 2) uint32 keys."""
    _words(key)
    return split_key(key, int(num))


def _size(shape):
    return int(np.prod(shape, dtype=np.int64))


def random_bits(key, bit_width, shape, device=None):
    """JAX's ``random.bits``: uint32 (h1 ^ h2) or uint64 (h1 << 32 | h2)
    of the hash words of counters 0, 1, ... in row-major order, on
    ``device`` (default: the ``device`` option, else ``cuda``)."""
    if bit_width not in (32, 64):
        raise ValueError("bit_width must be 32 or 64, got %r"
                         % (bit_width,))
    shape = tuple(shape)
    return threefry_fill(key, 0, _size(shape), 'bits%d' % bit_width,
                         device=resolve_device(device)).reshape(shape)


def _kind(base, dtype):
    dt = np.dtype(dtype)
    if dt not in (np.dtype('f4'), np.dtype('f8')):
        raise ValueError("%s draws are f4 or f8, got %s" % (base, dt))
    return base + ('32' if dt.itemsize == 4 else '64')


def uniform(key, shape, dtype='f8', minval=0.0, maxval=1.0, device=None):
    """JAX's ``random.uniform`` (values in [minval, maxval)), on
    ``device`` as :func:`random_bits`."""
    shape = tuple(shape)
    return threefry_fill(key, 0, _size(shape), _kind('uniform', dtype),
                         minval, maxval,
                         device=resolve_device(device)).reshape(shape)


def normal(key, shape, dtype='f8', device=None):
    """JAX's ``random.normal``: sqrt(2) erf_inv(u), u uniform in
    (nextafter(-1, 0), 1), on ``device`` as :func:`random_bits`."""
    shape = tuple(shape)
    return threefry_fill(key, 0, _size(shape), _kind('normal', dtype),
                         device=resolve_device(device)).reshape(shape)


def poisson(key, lam, shape=None, device=None):
    """JAX's ``random.poisson(key, lam, shape)``: int64 counts. ``lam``
    (a tensor, or array-like placed on ``device``) is broadcast to
    ``shape`` and cast to f32, as JAX does."""
    if not isinstance(lam, torch.Tensor):
        lam = torch.as_tensor(np.asarray(lam),
                              device=resolve_device(device))
    if shape is not None:
        lam = lam.expand(tuple(shape))
    return poisson_threefry(key, lam)


class DistributedRNG(object):
    """A stateful RandomState-like façade over the threefry draws,
    producing tensors of length ``size`` (+ itemshape) on ``device``.

    Each call folds the next value of a call counter into the seed's
    key, so a sequence of calls reproduces the JAX package's
    ``DistributedRNG`` draw for draw."""

    def __init__(self, seed, size, device=None):
        self.seed = int(seed)
        self.size = int(size)
        self.device = resolve_device(device)
        self._counter = 0

    def _next_key(self):
        k = fold_in(key(self.seed), self._counter)
        self._counter += 1
        return k

    def _shape(self, itemshape):
        if itemshape is None:
            return (self.size,)
        if np.isscalar(itemshape):
            itemshape = (itemshape,)
        return (self.size,) + tuple(itemshape)

    def uniform(self, low=0.0, high=1.0, itemshape=None, dtype='f8'):
        return uniform(self._next_key(), self._shape(itemshape),
                       working_dtype(dtype), low, high, self.device)

    def normal(self, loc=0.0, scale=1.0, itemshape=None, dtype='f8'):
        g = normal(self._next_key(), self._shape(itemshape),
                   working_dtype(dtype), self.device)
        if (scale, loc) == (1.0, 0.0):
            return g
        # XLA contracts g * scale + loc into one fused multiply-add
        return fma(g, torch.full_like(g, scale), torch.full_like(g, loc))

    def poisson(self, lam, itemshape=None, dtype='i8'):
        lam = torch.as_tensor(lam, device=self.device) \
            if not isinstance(lam, torch.Tensor) else lam
        shape = self._shape(itemshape)
        if lam.dim() > 0:
            shape = torch.broadcast_shapes(shape, lam.shape)
        p = poisson(self._next_key(), lam, shape=shape)
        return p.to(torch_dtype(working_dtype(dtype)))

    def choice(self, choices, p=None, itemshape=None):
        raise NotImplementedError(
            "DistributedRNG.choice is not ported yet (ROADMAP, Queue A: "
            "'DistributedRNG.choice')")
