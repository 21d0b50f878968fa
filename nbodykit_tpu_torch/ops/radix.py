"""Stable counting/radix ordering for small-alphabet keys (counterpart of
``nbodykit_tpu/ops/radix.py``).

For keys drawn from a known alphabet of D values a stable counting sort
orders n keys in O(n):

  rank[i]  = #{j < i : key[j] == key[i]}   (the rank pass,
             ops/radix_cuda.py: a CUDA kernel on the card, the
             chunked one-hot scan on the CPU)
  start[d] = exclusive cumsum of the digit histogram
  dest[i]  = start[key[i]] + rank[i]       (a permutation)

Alphabets wider than 1024 take k stable LSD passes over balanced
base-ceil(D^(1/k)) digits, exactly as the JAX package does, so both
give the same permutation as a stable argsort.
"""

import numpy as np
import torch

from .radix_cuda import pass_rank_hist as _rank_hist


def stable_digit_dest(digit, D):
    """dest[i] = stable-counting-sort position of element i; a
    permutation of [0, n) (int64)."""
    rank, hist = _rank_hist(digit, D)
    hist = hist.to(torch.int64)
    start = torch.cumsum(hist, 0) - hist           # exclusive
    return start[digit.long()] + rank


def _invert_perm(dest):
    """order[dest[i]] = i."""
    n = dest.shape[0]
    order = torch.empty(n, dtype=torch.int64, device=dest.device)
    order[dest] = torch.arange(n, dtype=torch.int64, device=dest.device)
    return order


def stable_key_order(key, D, radix=1024):
    """Permutation ``order`` (int64) with ``key[order]`` stably sorted,
    for keys in [0, D). One counting pass when D <= ``radix``, else
    k = ceil(log_radix(D)) LSD passes over base-ceil(D^(1/k)) digits."""
    n = key.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=key.device)
    key = key.to(torch.int32)
    if D <= radix:
        return _invert_perm(stable_digit_dest(key, D))
    npasses = int(np.ceil(np.log(D) / np.log(radix)))
    R = int(np.ceil(D ** (1.0 / npasses)))
    order = None
    f = 1
    for _ in range(npasses):
        k_cur = key if order is None else key[order]
        dig = torch.remainder(torch.div(k_cur, f, rounding_mode='floor'), R)
        step = _invert_perm(stable_digit_dest(dig.to(torch.int32), R))
        order = step if order is None else order[step]
        f *= R
    return order


def order_keys(key, D, method='auto'):
    """Stable ordering with an explicit engine: 'argsort'
    (``torch.argsort(stable=True)``), 'radix' (:func:`stable_key_order`)
    or 'auto' (radix on a CUDA device, argsort on the CPU). Both engines
    are stable, so the permutation is the same."""
    if method == 'auto':
        method = 'radix' if key.device.type == 'cuda' else 'argsort'
    if method == 'radix':
        return stable_key_order(key, D)
    if method == 'argsort':
        return torch.argsort(key, stable=True)
    raise ValueError("unknown order method %r (choose "
                     "'auto'/'radix'/'argsort')" % (method,))
