"""Slab domain decomposition for the particle algorithms (counterpart of
``nbodykit_tpu/parallel/domain.py``).

The reference decomposes particles over its MPI ranks with ghost copies
within an interaction radius (``pmesh.domain.GridND.decompose``: FOF,
the pair counts, KDDensity). Here the ranks own x-slabs, as the slab
FFT does:

- :func:`slab_route`: the destination of every particle and of its
  ghost copies within ``rmax`` of a slab face, as a :class:`Route`;
- :class:`Route`: a frozen plan over the counted exchange
  (:func:`.exchange.exchange_by_dest`). Its slot layout is a function
  of the destinations and the capacity alone, so each new payload
  comes back aligned slot for slot with the first (the reference's one
  ``layout`` exchanging many columns);
- :func:`scatter_reduce_by_index` / :func:`gather_by_index`: a reduce
  into, and a lookup from, a table held across the ranks, each entry
  shipped to the rank that owns its index (the reference's
  ``layout.gather(arr, mode=...)`` and its distributed array lookups).

A table of ``size`` global entries is held in rows: rank r holds
``[starts[r], starts[r] + counts[r])``. The default is the catalogs'
own split (:func:`.runtime.row_range`, ``ceil(size/P)`` a rank, the JAX
package's padded layout without its pad), so index ``i`` lives on rank
``i // ceil(size/P)``; a catalog whose rows are split otherwise passes
its ``counts`` (:func:`rows_layout`).

The JAX package's payloads are tiled ``f`` times and every copy ships,
dead ones with a ``live`` mask, because its shapes are static. Here
only the live copies travel: a route's ``valid`` already excludes the
dead ones, and a payload may be given per particle (``n`` rows) as well
as tiled (``f * n``).
"""

import numpy as np
import torch

from .exchange import auto_capacity, exchange_by_dest
from .runtime import mesh_size


class Route(object):
    """A frozen exchange plan: the destination of every copy shipped and
    the capacity of each (source, destination) pair.

    dest : (m,) destination rank of each copy; mesh : the RankMesh;
    capacity : default the exact bound (:func:`.exchange.auto_capacity`);
    rows : (m,) the row of the tiled payload (``f * n`` rows, the JAX
    package's layout) each copy carries, None when copy i is row i;
    n : the particles (rows of a payload given per particle).

    :meth:`exchange` returns (recv, valid, dropped) as
    :func:`.exchange.exchange_by_dest` does; successive calls return
    arrays aligned slot for slot. ``edges`` holds the slab boundaries a
    :func:`slab_route` used (None for the uniform slabs).
    """

    def __init__(self, dest, mesh, capacity=None, rows=None, n=None):
        self.dest = dest
        self.mesh = mesh
        self.nproc = mesh_size(mesh)
        self.rows = rows
        self.n = int(dest.shape[0] if n is None else n)
        if capacity is None and self.nproc > 1:
            capacity = auto_capacity(dest, mesh)
        self.capacity = capacity
        self.edges = None

    def payload(self, a):
        """The copies of payload ``a`` this route ships: ``a`` itself
        without ``rows``, else the rows of a tiled payload, or of a
        payload given per particle."""
        if self.rows is None:
            return a
        if a.shape[0] == self.n:
            return a[self.rows % max(self.n, 1)]
        return a[self.rows]

    def exchange(self, arrays):
        """(recv_list, valid, dropped): each payload as this rank's
        receive buffer (:func:`.exchange.exchange_by_dest`)."""
        return exchange_by_dest(self.dest, [self.payload(a) for a in arrays],
                                self.mesh, self.capacity)


def balanced_slab_edges(x, box0, nproc, rmax=None, oversample=64,
                        mesh=None):
    """Slab boundaries that equalize the particles a rank: the quantiles
    of a histogram of ``x`` in ``oversample * nproc`` uniform bins
    (linear inside a bin), the reference's ``domain.loadbalance``. With
    ``rmax`` every slab is clamped to at least ``rmax`` wide, so one
    hop of ghosts stays enough (callers check ``nproc * rmax <= box0``).

    x : this rank's x coordinates; mesh : the ranks holding the rows of
    ``x``, whose histograms are summed before the edges are cut (None:
    ``x`` is the whole catalog). Returns a host (nproc + 1,) float64
    array, the same on every rank, from 0 to box0.
    """
    box0 = float(box0)
    nbins = int(oversample) * nproc
    bw = box0 / nbins
    xb = torch.clamp((torch.remainder(x, box0) / bw).to(torch.int32),
                     0, nbins - 1)
    hist = torch.bincount(xb, minlength=nbins)
    if mesh_size(mesh) > 1:
        hist = mesh.all_reduce(hist)
    hist = hist.cpu().numpy().astype('f8')
    csum = np.concatenate([[0.0], np.cumsum(hist)])
    total = csum[-1]
    grid = np.linspace(0.0, box0, nbins + 1)
    if total <= 0:
        return np.linspace(0.0, box0, nproc + 1)
    targets = total * np.arange(1, nproc) / nproc
    cuts = np.interp(targets, csum, grid)
    edges = np.concatenate([[0.0], cuts, [box0]])
    if rmax is not None and rmax > 0:
        m = float(rmax)
        for k in range(1, nproc):
            edges[k] = max(edges[k], edges[k - 1] + m)
        for k in range(nproc - 1, 0, -1):
            edges[k] = min(edges[k], edges[k + 1] - m)
    return edges


def slab_route(pos, box, rmax, mesh, ghosts='down', periodic=True,
               balance=False, edges=None):
    """The route of this rank's particles, and their ghost copies, to
    the owners of their x-slabs.

    A particle goes to the slab that holds its x (periodic: x mod the
    box). A copy within ``rmax`` of a slab face also goes across it:

    - ``ghosts='down'``: to the lower neighbour only (FOF: every linked
      pair is then whole on the lower slab of the two);
    - ``ghosts='both'``: to both neighbours (pair counts, KDDensity:
      every owner copy sees every particle within rmax);
    - ``ghosts=None``: no ghosts (the primaries of a pair count).

    ``balance=True`` cuts the slabs at the quantiles of the particles'
    x over every rank (:func:`balanced_slab_edges`); ``edges`` reuses
    boundaries, so that two routes share one decomposition. With two
    ranks, periodic, the lower and upper neighbour are one rank: a
    particle near both faces ships one ghost.

    Returns (route, f, live) as the JAX package does: ``f`` (1, 2 or 3)
    copies a particle, ``live`` the (f * n,) mask of the copies that
    exist (the owner copies first). Only the live copies travel: the
    route's ``valid`` is already that mask's. Requires rmax <= box_x /
    P (one hop of ghosts)."""
    nproc = mesh_size(mesh)
    n = pos.shape[0]
    dev = pos.device
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    if nproc == 1:
        route = Route(torch.zeros(n, dtype=torch.int32, device=dev), mesh)
        return route, 1, ones

    box0 = float(np.asarray(box, dtype='f8').reshape(-1)[0])
    w = box0 / nproc
    if rmax is not None and rmax > w:
        raise ValueError(
            "interaction radius %g exceeds the slab width %g "
            "(= BoxSize[0]=%g / %d ranks)" % (rmax, w, box0, nproc))

    x = pos[:, 0].contiguous()
    if periodic:
        x = torch.remainder(x, box0)
    if edges is None and balance:
        edges = balanced_slab_edges(x, box0, nproc, rmax, mesh=mesh)
    if edges is not None:
        edges = np.asarray(edges, dtype='f8')
        e = torch.as_tensor(edges, dtype=x.dtype, device=dev)
        owner = torch.clamp(torch.searchsorted(e[1:-1].contiguous(), x,
                                               right=True),
                            0, nproc - 1).to(torch.int32)
        lo_edge = e[owner.long()]
        hi_edge = e[owner.long() + 1]
    else:
        owner = torch.clamp((x / w).to(torch.int32), 0, nproc - 1)
        lo_edge = owner.to(x.dtype) * w
        hi_edge = (owner.to(x.dtype) + 1) * w

    if ghosts is None or rmax is None:
        route = Route(owner, mesh)
        route.edges = edges
        return route, 1, ones

    lo_margin = (x - lo_edge) < rmax
    hi_margin = (hi_edge - x) < rmax
    if periodic:
        lo_dest = torch.remainder(owner - 1, nproc)
        hi_dest = torch.remainder(owner + 1, nproc)
    else:
        lo_margin = lo_margin & (owner > 0)
        hi_margin = hi_margin & (owner < nproc - 1)
        lo_dest = torch.clamp(owner - 1, min=0)
        hi_dest = torch.clamp(owner + 1, max=nproc - 1)

    if ghosts == 'down':
        dest = torch.cat([owner, torch.where(lo_margin, lo_dest, owner)])
        live = torch.cat([ones, lo_margin])
        f = 2
    elif ghosts == 'both':
        if nproc == 2 and periodic:
            hi_margin = hi_margin & ~lo_margin
        dest = torch.cat([owner, torch.where(lo_margin, lo_dest, owner),
                          torch.where(hi_margin, hi_dest, owner)])
        live = torch.cat([ones, lo_margin, hi_margin])
        f = 3
    else:
        raise ValueError("ghosts must be 'down', 'both' or None")
    rows = torch.nonzero(live).squeeze(1)
    route = Route(dest[rows], mesh, rows=rows, n=n)
    route.edges = edges
    return route, f, live


def padded_size(size, nproc):
    """(padded_total, per_rank) of a table of ``size`` entries over
    ``nproc`` ranks: ``per_rank = ceil(size / nproc)``."""
    per = -(-size // nproc)
    return per * nproc, per


def rows_layout(n, mesh):
    """(counts, start): every rank's row count, in rank order, and this
    rank's first global index, for a table of which this rank holds
    ``n`` rows (a collective; ([n], 0) on one rank)."""
    if mesh_size(mesh) == 1:
        return [int(n)], 0
    got = mesh.all_gather(torch.tensor([int(n)], device=mesh.device))
    counts = [int(v) for v in got.reshape(-1).cpu()]
    return counts, sum(counts[:mesh.rank])


def _table_rows(size, mesh, counts):
    """(ends, start, rows) of a table: the exclusive end of every rank's
    rows (a tensor on the mesh's device), this rank's first index and
    its row count; ``counts`` None is the row split of ``size``."""
    nproc = mesh_size(mesh)
    if counts is None:
        _, per = padded_size(int(size), nproc)
        counts = [max(0, min(per, int(size) - r * per)) for r in range(nproc)]
    if sum(counts) != int(size):
        raise ValueError("counts %s do not add up to the table's %d "
                         "entries" % (counts, size))
    ends = torch.as_tensor(np.cumsum(counts), dtype=torch.int64,
                           device=mesh.device)
    start = sum(counts[:mesh.rank])
    return ends, start, counts[mesh.rank]


def _owner(idx, ends):
    """The rank whose rows hold each global index."""
    return torch.searchsorted(ends, idx.to(torch.int64),
                              right=True).to(torch.int32)


def _neutral(op, dtype):
    if dtype.is_floating_point:
        return {'add': 0.0, 'min': float('inf'), 'max': float('-inf')}[op]
    if dtype == torch.bool:
        raise TypeError("scatter_reduce_by_index reduces numbers")
    info = torch.iinfo(dtype)
    return {'add': 0, 'min': info.max, 'max': info.min}[op]


def _reduce_into(out, idx, vals, op):
    """``out[idx] op= vals`` in place (rows of any trailing shape)."""
    idx = idx.to(torch.int64)
    if op == 'add':
        return out.index_add_(0, idx, vals)
    if vals.ndim > 1:
        idx = idx.reshape((-1,) + (1,) * (vals.ndim - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, 'amin' if op == 'min'
                               else 'amax', include_self=True)


def scatter_reduce_by_index(idx, vals, size, mesh, op='add', valid=None,
                            init=None, counts=None):
    """``out[idx] op= vals`` on a table held across the ranks.

    idx : (M,) global indices in [0, size) of this rank's entries;
    vals : (M, ...) their values; op : 'add', 'min' or 'max'; valid :
    (M,) bool, the entries that take part (None: all); init : this
    rank's rows of an existing table to reduce into (default: the op's
    neutral value); counts : every rank's row count of the table
    (default: the row split of ``size``).

    Returns this rank's rows of the table. Each (index, value) pair
    ships to the rank owning the index, which reduces it into its rows:
    no rank holds the whole table."""
    nproc = mesh_size(mesh)
    neutral = _neutral(op, vals.dtype)
    if valid is not None:
        keep = torch.nonzero(valid).squeeze(1)
        idx, vals = idx[keep], vals[keep]
    if nproc == 1:
        out = torch.full((int(size),) + tuple(vals.shape[1:]), neutral,
                         dtype=vals.dtype, device=vals.device) \
            if init is None else init.clone()
        return _reduce_into(out, idx, vals, op)
    ends, start, rows = _table_rows(size, mesh, counts)
    (idx_r, val_r), ok, _ = exchange_by_dest(_owner(idx, ends), [idx, vals],
                                             mesh)
    got = torch.nonzero(ok).squeeze(1)
    out = torch.full((rows,) + tuple(vals.shape[1:]), neutral,
                     dtype=vals.dtype, device=vals.device) \
        if init is None else init.clone()
    return _reduce_into(out, idx_r[got].to(torch.int64) - start, val_r[got],
                        op)


def gather_by_index(idx, table, mesh):
    """``table[idx]`` on a table held across the ranks, by request and
    response (no rank gathers the table).

    idx : (M,) global indices of this rank's lookups; table : this
    rank's rows of the table, in rank order (any split: the ranks' row
    counts are gathered). Returns (M, ...) values."""
    if mesh_size(mesh) == 1:
        return table[idx.to(torch.int64)]
    counts, start = rows_layout(table.shape[0], mesh)
    ends = torch.as_tensor(np.cumsum(counts), dtype=torch.int64,
                           device=table.device)
    M = idx.shape[0]
    reqid = torch.arange(M, dtype=torch.int64, device=idx.device)
    (idx_r, req_r), ok, _ = exchange_by_dest(_owner(idx, ends),
                                             [idx, reqid], mesh)
    got = torch.nonzero(ok).squeeze(1)
    # the receive buffer holds P blocks of capacity slots, in source order
    source = (got // (ok.shape[0] // mesh.size)).to(torch.int32)
    vals = table[idx_r[got].to(torch.int64) - start]
    (req_b, val_b), ok_b, _ = exchange_by_dest(source, [req_r[got], vals],
                                               mesh)
    back = torch.nonzero(ok_b).squeeze(1)
    out = torch.empty((M,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    out[req_b[back]] = val_b[back]
    return out


def global_bounds(pos, mesh):
    """(lo, hi): the least and largest coordinates of every rank's
    positions, (3,) f64 tensors on every rank (one ``all_reduce`` of the
    minima and the negated maxima; an empty rank adds +inf)."""
    inf = torch.full((3,), float('inf'), dtype=torch.float64,
                     device=pos.device)
    lo = pos.min(dim=0).values if pos.shape[0] else inf
    nhi = (-pos).min(dim=0).values if pos.shape[0] else inf
    both = torch.stack([lo, nhi]).to(torch.float64)
    if mesh_size(mesh) > 1:
        both = mesh.all_reduce(both, 'min')
    return both[0], -both[1]


def allgather_rows(t, mesh):
    """Every rank's rows of ``t`` concatenated in rank order, on every
    rank (a collective; ``t`` on one rank)."""
    if mesh_size(mesh) == 1:
        return t
    counts, _ = rows_layout(t.shape[0], mesh)
    send = torch.cat([t] * mesh.size)
    return mesh.all_to_all(send, [t.shape[0]] * mesh.size, counts)
