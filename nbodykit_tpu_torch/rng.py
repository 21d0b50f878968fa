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
  CUDA device, their plain versions on the CPU;
- ``randint`` and ``choice`` follow ``jax.random`` (x64) on those draws.

Bits, uniforms, integers, choices (with f8 probabilities) and Poisson
counts (given the same lam) equal JAX's bit for bit. Normals use XLA's
``erf_inv`` arithmetic, but torch's ``log1p`` is not XLA's: f32 normals
differ from JAX's by at most a few ulp, f64 normals by ~1e-15.
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


def random_bits(key, bit_width, shape, device=None, offset=0):
    """JAX's ``random.bits``: uint32 (h1 ^ h2) or uint64 (h1 << 32 | h2)
    of the hash words of counters 0, 1, ... in row-major order, on
    ``device`` (default: the ``device`` option, else ``cuda``).

    ``offset`` (here and in the draws below) starts the counters there:
    the elements [offset, offset + size) of a larger draw, as a rank
    draws its rows of a global one."""
    if bit_width not in (32, 64):
        raise ValueError("bit_width must be 32 or 64, got %r"
                         % (bit_width,))
    shape = tuple(shape)
    return threefry_fill(key, offset, _size(shape), 'bits%d' % bit_width,
                         device=resolve_device(device)).reshape(shape)


def _kind(base, dtype):
    dt = np.dtype(dtype)
    if dt not in (np.dtype('f4'), np.dtype('f8')):
        raise ValueError("%s draws are f4 or f8, got %s" % (base, dt))
    return base + ('32' if dt.itemsize == 4 else '64')


def uniform(key, shape, dtype='f8', minval=0.0, maxval=1.0, device=None,
            offset=0):
    """JAX's ``random.uniform`` (values in [minval, maxval)), on
    ``device`` as :func:`random_bits`."""
    shape = tuple(shape)
    return threefry_fill(key, offset, _size(shape), _kind('uniform', dtype),
                         minval, maxval,
                         device=resolve_device(device)).reshape(shape)


def normal(key, shape, dtype='f8', device=None, offset=0):
    """JAX's ``random.normal``: sqrt(2) erf_inv(u), u uniform in
    (nextafter(-1, 0), 1), on ``device`` as :func:`random_bits`."""
    shape = tuple(shape)
    return threefry_fill(key, offset, _size(shape), _kind('normal', dtype),
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


def randint(key, shape, minval, maxval, device=None, offset=0):
    """JAX's ``random.randint`` at int64 (x64 on): two 64-bit
    ``random_bits`` draws under ``split(key)``, the high one reduced
    through the multiplier ``(2^32 mod span)^2 mod span``, as in JAX.
    ``minval`` and ``maxval`` are Python ints with a span (1 when
    ``maxval <= minval``) below 2^31, where the int64 arithmetic here is
    exact and equals JAX's uint64 arithmetic."""
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    if span >= 2 ** 31:
        raise ValueError("randint supports spans below 2^31, got %d"
                         % span)
    shape = tuple(shape)
    device = resolve_device(device)
    k1, k2 = split(key)
    two32 = (1 << 32) % span
    mult = two32 * two32 % span

    def reduced(k):
        # a 64-bit draw (hi << 32 | lo) mod span, from its two words
        b = random_bits(k, 64, shape, device, offset).view(torch.int64)
        hi, lo = (b >> 32) & M32, b & M32
        return ((hi % span) * two32 + lo % span) % span

    offset = (reduced(k1) * mult + reduced(k2)) % span
    return offset + minval


# the block length of XLA's cumulative-sum rewrite on the CPU
CUMSUM_BLOCK = 16


def _sequential_cumsum(x):
    """Inclusive prefix sums of the last axis, added left to right."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def cumsum_xla(x):
    """``jnp.cumsum`` of a 1-D tensor in XLA's CPU order, bit for bit:
    up to ``CUMSUM_BLOCK`` elements a left-to-right sum; beyond, blocks
    of ``CUMSUM_BLOCK`` summed left to right, each offset by the
    exclusive prefix of the block totals, taken the same way. The
    explicit order makes the sums the same on every device."""
    n = x.numel()
    if n <= CUMSUM_BLOCK:
        return _sequential_cumsum(x)
    m = -(-n // CUMSUM_BLOCK)
    padded = torch.zeros(m * CUMSUM_BLOCK, dtype=x.dtype, device=x.device)
    padded[:n] = x
    inner = _sequential_cumsum(padded.reshape(m, CUMSUM_BLOCK))
    outer = torch.zeros(m, dtype=x.dtype, device=x.device)
    outer[1:] = cumsum_xla(inner[:, -1])[:-1]
    return (inner + outer[:, None]).reshape(-1)[:n]


def _on(x, device):
    """``x`` (a tensor or array-like) as a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def choice(key, choices, shape, p=None, device=None, offset=0):
    """JAX's ``random.choice(key, choices, shape, replace=True, p=p)``
    at x64: without ``p`` a ``randint`` index; with ``p`` the left
    ``searchsorted`` of ``p_cuml[-1] * (1 - uniform)`` in ``p_cuml``,
    the cumulative sum in XLA's order (:func:`cumsum_xla`). ``choices``
    is an int n (draw from arange(n)) or an array-like whose leading
    axis is drawn from; the result has shape ``shape`` plus its trailing
    axes, on ``device``."""
    device = resolve_device(device)
    shape = tuple(shape)
    arr = _on(choices, device)
    scalar = arr.dim() == 0
    n = int(arr) if scalar else arr.shape[0]
    n_draws = _size(shape)
    if n_draws == 0:
        dt = torch.int64 if scalar else arr.dtype
        return torch.zeros(shape if scalar else shape + tuple(arr.shape[1:]),
                           dtype=dt, device=device)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if p is None:
        ind = randint(key, shape, 0, n, device, offset)
    else:
        p = _on(p, device)
        if not p.is_floating_point():
            p = p.to(torch.float64)
        if tuple(p.shape) != (n,):
            raise ValueError("p must be None or a 1D vector with the same "
                             "size as a.shape[axis]. p has shape %s and "
                             "a.shape[axis] is %d." % (tuple(p.shape), n))
        p_cuml = cumsum_xla(p)
        dt = 'f8' if p.dtype == torch.float64 else 'f4'
        u = uniform(key, shape, dt, device=device, offset=offset)
        r = p_cuml[-1] * (1 - u)
        ind = torch.searchsorted(p_cuml, r.reshape(-1)).reshape(shape)
    if scalar:
        return ind
    return arr[ind]


class DistributedRNG(object):
    """A stateful RandomState-like façade over the threefry draws,
    producing tensors of length ``size`` (+ itemshape) on ``device``.

    Each call folds the next value of a call counter into the seed's
    key, so a sequence of calls reproduces the JAX package's
    ``DistributedRNG`` draw for draw. With a ``comm`` of P ranks,
    ``size`` is the global length and each rank draws the counters of
    its own rows (:func:`~.parallel.runtime.row_range`): the union over
    the ranks equals the one-rank draw bit for bit. The Poisson draw
    cannot be cut so (its rejection loop runs over the whole draw) and
    refuses more than one rank."""

    def __init__(self, seed, size, device=None, comm=None):
        from .parallel.runtime import CurrentMesh, row_range
        self.seed = int(seed)
        self.size = int(size)
        self.comm = CurrentMesh.resolve(comm)
        if self.comm is not None and device is None:
            device = self.comm.device
        self.device = resolve_device(device)
        self._start, self._stop = (0, self.size) if self.comm is None \
            else row_range(self.size, self.comm.size, self.comm.rank)
        self._counter = 0

    def _next_key(self):
        k = fold_in(key(self.seed), self._counter)
        self._counter += 1
        return k

    def _shape(self, itemshape):
        if itemshape is None:
            itemshape = ()
        elif np.isscalar(itemshape):
            itemshape = (itemshape,)
        return (self._stop - self._start,) + tuple(itemshape)

    def _offset(self, shape):
        """The first counter of this rank's rows of a draw of ``shape``
        (this rank's)."""
        return self._start * _size(shape[1:])

    def uniform(self, low=0.0, high=1.0, itemshape=None, dtype='f8'):
        shape = self._shape(itemshape)
        return uniform(self._next_key(), shape, working_dtype(dtype), low,
                       high, self.device, self._offset(shape))

    def normal(self, loc=0.0, scale=1.0, itemshape=None, dtype='f8'):
        shape = self._shape(itemshape)
        g = normal(self._next_key(), shape, working_dtype(dtype),
                   self.device, self._offset(shape))
        if (scale, loc) == (1.0, 0.0):
            return g
        # XLA contracts g * scale + loc into one fused multiply-add
        return fma(g, torch.full_like(g, scale), torch.full_like(g, loc))

    def poisson(self, lam, itemshape=None, dtype='i8'):
        if self.comm is not None and self.comm.size > 1:
            raise NotImplementedError(
                "the Poisson draw runs on one rank: its rejection loop "
                "runs over the whole draw (ROADMAP.md, Queue A: modules to "
                "port)")
        lam = torch.as_tensor(lam, device=self.device) \
            if not isinstance(lam, torch.Tensor) else lam
        shape = self._shape(itemshape)
        if lam.dim() > 0:
            shape = torch.broadcast_shapes(shape, lam.shape)
        p = poisson(self._next_key(), lam, shape=shape)
        return p.to(torch_dtype(working_dtype(dtype)))

    def choice(self, choices, p=None, itemshape=None):
        """Draws with replacement from ``choices`` (an int n or an
        array), uniform or with probabilities ``p``, as
        ``jax.random.choice`` under the next key."""
        shape = self._shape(itemshape)
        return choice(self._next_key(), choices, shape, p=p,
                      device=self.device, offset=self._offset(shape))
