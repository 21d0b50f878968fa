"""Blocked direct-summation Fourier modes (counterpart of
``nbodykit_tpu/ops/pairblock.py``).

The direct estimator of a density mode at wavevector ``k_q`` is the
O(Npart x Nk) sum

    delta(k_q) = sum_j w_j exp(-i k_q . x_j)

(the forward sign of ``pmesh.r2c``). A block of positions against a
block of wavevectors is one dense product, the phase block
``ph = pos @ kvecs.T``; the particle-axis contraction of its cos/sin
images against the weights, ``w @ cos(ph)`` and ``w @ sin(ph)``, is a
second. The JAX package runs this through XLA, not Pallas, so it stays
torch here: one Python step per block, with blocks as large as
:data:`BLOCK_ELEMENTS` allows, not one per (tile, tile) pair.

Precision: phases are computed in the position dtype; the
accumulators widen to the common dtype of the positions and weights.

Across ranks each rank sums its own particles and one f64 ``all_reduce``
of the stacked (re, im) adds the ranks' sums (the JAX package pads the
catalog to equal shards for ``shard_map`` and ``psum``s).
"""

import numpy as np
import torch

from ..parallel.runtime import mesh_size

# The cold-cache ``pairblock_tile`` of the JAX tuner (tune/resolve.py
# FALLBACKS): the tile edge that ``tile=None`` resolves to
DEFAULT_TILE = 1024
# Elements of one phase block: its cos and sin images and the phase
# itself are live together, so a step holds about 3x this many values
BLOCK_ELEMENTS = 1 << 25


def _pad_rows(x, n, fill=0):
    """Pad the leading axis of ``x`` up to ``n`` rows with ``fill``."""
    m = int(x.shape[0])
    if m == n:
        return x
    pad = torch.full((n - m,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _pairblock_tiles(pos, w, kvecs, tile_p, tile_k):
    """``(re, im)`` with ``re[q] = sum_j w_j cos(k_q . x_j)`` and the
    matching sin sum. ``pos`` has a multiple of ``tile_p`` rows
    (zero-weight padding rows add exactly 0), ``kvecs`` a multiple of
    ``tile_k`` (the caller drops the padding rows). Each step takes as
    many whole tiles of both axes as fit in :data:`BLOCK_ELEMENTS`."""
    Np, Nk = int(pos.shape[0]), int(kvecs.shape[0])
    acc = torch.promote_types(pos.dtype, w.dtype)
    bk = min(Nk, max(tile_k, BLOCK_ELEMENTS // tile_p // tile_k * tile_k))
    bp = min(Np, max(tile_p, BLOCK_ELEMENTS // bk // tile_p * tile_p))
    re = torch.zeros(Nk, dtype=acc, device=pos.device)
    im = torch.zeros(Nk, dtype=acc, device=pos.device)
    for k0 in range(0, Nk, bk):
        kt = kvecs[k0:k0 + bk]
        for p0 in range(0, Np, bp):
            ph = pos[p0:p0 + bp] @ kt.T
            wt = w[p0:p0 + bp].to(ph.dtype)
            re[k0:k0 + bk] += wt @ torch.cos(ph)
            im[k0:k0 + bk] += wt @ torch.sin(ph)
    return re, im


def pairblock_sum(pos, w, kvecs, tile=None, comm=None):
    """``sum_j w_j exp(-i k_q . x_j)`` for every row ``k_q`` of
    ``kvecs``: the blocked direct Fourier sum, on the device of
    ``pos``.

    pos : (Np, 3) positions (phases are computed in their dtype);
    w : (Np,) weights; kvecs : (Nk, 3) wavevectors (numpy or tensor);
    tile : tile edge of both axes, the unit of the padding and of the
    blocks (``None``: the JAX tuner's cold-cache 1024); comm : a mesh
    of ranks over which the particles are split, ``pos`` and ``w``
    this rank's rows (None: one rank).

    Returns a complex (Nk,) tensor ``re - 1j * im``, the same on every
    rank.
    """
    pos = torch.as_tensor(pos)
    w = torch.as_tensor(w, device=pos.device).to(pos.dtype)
    kvecs = torch.as_tensor(kvecs, device=pos.device).to(pos.dtype)
    Nk = int(kvecs.shape[0])
    tile = max(int(DEFAULT_TILE if tile is None else tile), 8)
    tile_k = min(tile, max(8, Nk))
    kv = _pad_rows(kvecs, -(-Nk // tile_k) * tile_k)
    Np = int(pos.shape[0])
    tile_p = min(tile, max(8, Np))
    # a rank without particles sums one tile of zero weights
    np_pad = max(-(-Np // tile_p), 1) * tile_p
    re, im = _pairblock_tiles(_pad_rows(pos, np_pad), _pad_rows(w, np_pad),
                              kv, tile_p, tile_k)
    if mesh_size(comm) > 1:
        both = comm.all_reduce(torch.stack([re, im]).to(torch.float64))
        re, im = both[0].to(re.dtype), both[1].to(im.dtype)
    return (re - 1j * im)[:Nk]


def lattice_kvecs(qvecs, BoxSize):
    """Physical wavevectors ``(2 pi / L) * q`` for integer lattice mode
    triples ``qvecs`` (host numpy, (Nk, 3) int): the bispectrum's
    direct-path mode list."""
    q = np.asarray(qvecs, dtype='f8')
    L = np.ones(3) * np.asarray(BoxSize, dtype='f8')
    return q * (2.0 * np.pi / L)
