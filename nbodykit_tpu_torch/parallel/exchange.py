"""Particle exchange: route particles to the rank that owns their slab
(counterpart of ``nbodykit_tpu/parallel/exchange.py``).

The reference's MPI all-to-allv of a ragged partition becomes a
fixed-capacity exchange, as in the JAX package:

1. each rank computes dest(p) for its rows;
2. the rows are bucketed into a (P, capacity) send buffer, each at its
   stable rank within its destination bucket;
3. one equal-split ``all_to_all_single`` a payload ships the buckets;
4. the receive side is a (P, capacity) buffer with a validity mask.

Each rank pads its rows to the longest rank's count (rows with dest 0,
dead), the JAX package's padding of the global particle axis, so with
the row split of :func:`~.runtime.row_range` every buffer, ``valid``
and ``dropped`` equals the JAX package's rank block bit for bit. The
capacity is the exact bound from the (P, P) count matrix of every
(source, destination) pair unless given; an explicit capacity that
overflows drops particles and counts them in ``dropped``, summed over
the ranks so every rank sees the same count.

The bucket rank is the radix rank pass (``ops/radix_cuda.pass_rank_hist``
at an alphabet of P, the hand kernel) on a CUDA tensor and a stable
argsort on the CPU; both give every particle the same slot.

The route is differentiable in its payloads: the bucketing is a
scatter, the wire ``RankMesh.all_to_all``, whose backward sends each
cotangent back to the row it came from.
"""

import numpy as np
import torch

from .runtime import mesh_size


def counted_capacity(pm_or_mesh, pos_or_dest, slack=1.05, n0=None):
    """Pass 1 of the counted exchange: the exact per-(source,
    destination) count with ``slack`` headroom, a Python int every rank
    agrees on.

    pm_or_mesh : a ParticleMesh (routing then goes through
        ``pm.exchange_capacity``, the paint's own rule), or a
        :class:`~.runtime.RankMesh` (or None: one rank), in which case
        ``pos_or_dest`` is (n,) destination ranks or (n, 3) positions in
        cell units with the slab height ``n0``
    """
    if hasattr(pm_or_mesh, 'nproc'):
        return pm_or_mesh.exchange_capacity(pos_or_dest, slack=slack)
    mesh = pm_or_mesh
    t = torch.as_tensor(pos_or_dest)
    if t.ndim == 2:
        if n0 is None:
            raise ValueError("pass n0 (slab height) with raw positions")
        dest = torch.div(torch.floor(t[:, 0]).to(torch.int32), int(n0),
                         rounding_mode='floor')
    else:
        dest = t.to(torch.int32)
    if mesh_size(mesh) == 1:
        return int(dest.shape[0])
    return auto_capacity(dest, mesh, slack=slack)


def count_matrix(dest, mesh):
    """The (P, P) int64 matrix of particles each source rank (row)
    sends to each destination (column), gathered from every rank's
    local counts."""
    nproc = mesh_size(mesh)
    counts = torch.bincount(dest.long().clamp(0, nproc - 1),
                            minlength=nproc)
    return mesh.all_gather(counts)


def auto_capacity(dest, mesh, slack=1.05):
    """The exact sufficient per-(source, destination) capacity of an
    exchange of this rank's ``dest`` rows: the largest entry of
    :func:`count_matrix` times ``slack``, plus 8 (the JAX package's
    rule)."""
    most = int(count_matrix(dest, mesh).max())
    return int(np.ceil(most * slack)) + 8


def _bucket_local(dest, arrays, nproc, capacity, fill=0.0, live=None):
    """Pack this rank's payloads into (nproc, capacity, ...) buffers.

    dest : (n,) destination rank of each row; arrays : (n, ...)
    payloads; live : optional (n,) bool, the rows ``dropped`` counts.
    Returns (buffers, valid, dropped): valid is the (nproc, capacity)
    occupancy, dropped a 0-d count of live rows past a full bucket.
    """
    n = dest.shape[0]
    key = torch.clamp(dest.to(torch.int32), 0, nproc - 1)
    if key.is_cuda:
        from ..ops.radix_cuda import pass_rank_hist
        rank, _ = pass_rank_hist(key, nproc)
        rank = rank.long()
    else:
        order = torch.argsort(key, stable=True)
        skey = key[order]
        start = torch.searchsorted(
            skey, torch.arange(nproc, dtype=skey.dtype, device=key.device))
        rank = torch.empty(n, dtype=torch.int64, device=key.device)
        rank[order] = torch.arange(n, device=key.device) - \
            start[skey.long()]
    ok = rank < capacity
    lost = ~ok if live is None else (~ok & live)
    dropped = lost.sum()
    trash = nproc * capacity
    slot = torch.where(ok, key.long() * capacity + rank, trash)
    valid = torch.zeros(trash + 1, dtype=torch.bool, device=key.device)
    valid[slot] = True
    out = []
    for a in arrays:
        buf = torch.full((trash + 1,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        buf[slot] = a
        out.append(buf[:-1].reshape((nproc, capacity) + tuple(a.shape[1:])))
    return out, valid[:-1].reshape(nproc, capacity), dropped


def exchange_by_dest(dest, arrays, mesh, capacity=None, fill=0.0):
    """All-to-all exchange of this rank's payloads keyed by destination.

    dest : (n,) int destination rank of each of this rank's rows, in
        [0, P); arrays : list of (n, ...) payloads; mesh : the
        RankMesh (None or one rank: returned as given); capacity : rows
        a (source, destination) pair may carry, default the exact bound
        (:func:`auto_capacity`).

    Returns (recv, valid, dropped): each payload as this rank's
    (P * capacity, ...) receive buffer, blocks in source order; valid,
    the (P * capacity,) mask of real particles; dropped, a 0-d tensor,
    the particles lost to an overflowing capacity over all ranks (0
    with the default capacity).
    """
    nproc = mesh_size(mesh)
    n = dest.shape[0]
    dev = dest.device
    if nproc == 1:
        return (list(arrays), torch.ones(n, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    # every rank pads to the longest rank's rows, as the JAX package pads
    # the global particle axis: dead rows bound for rank 0
    per = int(mesh.all_reduce(torch.tensor([n], device=dev), 'max'))
    npad = per - n
    dest = dest.to(torch.int32)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    # under autograd every rank pads, with or without rows to add, so
    # every rank builds the same graph (runtime's module docstring)
    if npad or (torch.is_grad_enabled()
                and any(a.requires_grad for a in arrays)):
        dest = torch.cat([dest, torch.zeros(npad, dtype=dest.dtype,
                                            device=dev)])
        live = torch.cat([live, torch.zeros(npad, dtype=torch.bool,
                                            device=dev)])
        arrays = [torch.cat([a, torch.zeros((npad,) + tuple(a.shape[1:]),
                                            dtype=a.dtype, device=dev)])
                  for a in arrays]
    if capacity is None:
        capacity = auto_capacity(dest, mesh)
    capacity = int(capacity)
    bufs, slot_valid, dropped = _bucket_local(
        dest, [live] + list(arrays), nproc, capacity, fill, live=live)
    # a slot is valid when occupied by a live row: one mask on the wire
    valid = mesh.all_to_all((slot_valid & bufs[0]).reshape(-1))
    recv = [mesh.all_to_all(b.reshape((nproc * capacity,)
                                      + tuple(b.shape[2:])))
            for b in bufs[1:]]
    return recv, valid, mesh.all_reduce(dropped)
