"""The distributed sort (counterpart of ``nbodykit_tpu/parallel/sort.py``;
the reference's ``mpsort.sort``).

A stable sample sort over the ranks:

1. each rank sorts its rows (stably);
2. every rank's P - 1 quantiles are gathered and P - 1 global
   splitters cut out of them; equal keys go to one bucket;
3. the buckets travel through the counted exchange
   (:func:`.exchange.exchange_by_dest`), whose capacities are exact, so
   no bucket overflows and nothing is retried;
4. each rank sorts what it received (stably: the blocks arrive in
   source order, each in its source's sorted order);
5. a second exchange sends every entry to the rank of its global
   position, the row split of :func:`.runtime.row_range`.

Ties keep their global order (rank order, then row order), which the
multi-key LSD passes of ``CatalogSource.sort`` rely on.

Keys are int64 (:func:`sortable_key`): torch sorts signed integers,
where the JAX package maps columns to unsigned ones. The order is the
same, and no key value is reserved (the JAX package pads its shards
with the largest key; the counted exchange ships no padding).
"""

import torch

from .exchange import exchange_by_dest
from .runtime import mesh_size, row_range

_LOW63 = 0x7FFFFFFFFFFFFFFF
_LOW31 = 0x7FFFFFFF


def sortable_key(k, reverse=False):
    """An int64 key of a numeric column that sorts as the column does
    (``reverse``: the opposite way, by bit inversion). Floats take the
    IEEE order-preserving map (negative values get every bit but the
    sign flipped), so -0.0 sorts before +0.0 and NaNs past +inf, as in
    the JAX package; unsigned 64-bit keys flip their top bit."""
    k = torch.as_tensor(k)
    if k.dtype in (torch.float16, torch.bfloat16):
        k = k.to(torch.float32)
    if k.dtype == torch.float64:
        b = k.view(torch.int64)
        u = b ^ ((b >> 63) & _LOW63)
    elif k.dtype == torch.float32:
        b = k.view(torch.int32)
        u = (b ^ ((b >> 31) & _LOW31)).to(torch.int64)
    elif k.is_floating_point() or k.is_complex():
        raise TypeError("cannot build a sort key from dtype %s" % k.dtype)
    elif k.dtype == torch.uint64:
        u = k.view(torch.int64) ^ torch.iinfo(torch.int64).min
    else:
        u = k.to(torch.int64)
    return torch.bitwise_not(u) if reverse else u


def _take(arrays, order):
    return [a[order] for a in arrays]


def dist_sort(keys, values=None, mesh=None):
    """Sort ``keys`` over the ranks and reorder ``values`` (one tensor or
    a list of tensors) the same way; stable.

    keys : (n,) this rank's keys (a sortable dtype, e.g.
    :func:`sortable_key`'s int64); values : this rank's rows of each
    payload; mesh : the RankMesh (None: one rank).

    Returns this rank's rows of the sorted arrays, the row split of the
    total (:func:`.runtime.row_range`): ``keys_sorted`` alone,
    ``(keys_sorted, values_sorted)`` for one payload, or ``(keys_sorted,
    [values_sorted, ...])`` for a list."""
    multi = isinstance(values, (list, tuple))
    vlist = list(values) if multi else \
        ([] if values is None else [values])
    nproc = mesh_size(mesh)
    order = torch.argsort(keys, stable=True)
    ks, vs = keys[order], _take(vlist, order)
    if nproc > 1:
        ks, vs = _sample_sort(ks, vs, mesh)
    if values is None:
        return ks
    return ks, (vs if multi else vs[0])


def _sample_sort(ks, vs, mesh):
    """Steps 2-5 of the module docstring on this rank's sorted rows."""
    nproc, dev = mesh.size, ks.device
    n = ks.shape[0]
    total = int(mesh.all_reduce(torch.tensor([n], device=dev)))
    if total == 0:
        return ks, vs
    # P - 1 quantiles of each rank's rows; a rank with none sends none
    at = torch.linspace(0, max(n - 1, 0), nproc + 1,
                        device=dev).to(torch.int64)[1:-1]
    q = ks[at] if n else torch.zeros(nproc - 1, dtype=ks.dtype, device=dev)
    samples = mesh.all_gather(q)
    has = mesh.all_gather(torch.tensor([n > 0], device=dev)).reshape(-1)
    samples = torch.sort(samples[has].reshape(-1), stable=True).values
    split = samples[torch.arange(1, nproc, device=dev)
                    * samples.shape[0] // nproc]
    dest = torch.searchsorted(split.contiguous(), ks, right=True)
    (kr, *vr), ok, _ = exchange_by_dest(dest.to(torch.int32), [ks] + vs,
                                        mesh)
    got = torch.nonzero(ok).squeeze(1)
    kr, vr = kr[got], _take(vr, got)
    order = torch.argsort(kr, stable=True)
    kr, vr = kr[order], _take(vr, order)
    # every entry to the rank of its global position
    counts = mesh.all_gather(torch.tensor([kr.shape[0]], device=dev))
    prefix = int(counts.reshape(-1)[:mesh.rank].sum())
    _, per = row_range(total, nproc, 0)
    pos = prefix + torch.arange(kr.shape[0], device=dev)
    dest2 = (pos // per).to(torch.int32)
    (kf, *vf), ok, _ = exchange_by_dest(dest2, [kr] + vr, mesh)
    # blocks arrive in source order, each in order: the sorted rows
    got = torch.nonzero(ok).squeeze(1)
    return kf[got], _take(vf, got)
