"""The min-label sweeps of the grid-hash FOF: Hopper kernels and plain
versions.

Computes ``neighbor_min`` of ``nbodykit_tpu/ops/devicehash.py:190-194``,
which the JAX package folds over ``DeviceGridHash.fold`` (:148-168) as a
``lax.while_loop`` of gathers per neighbour offset (XLA; no Pallas
kernel). On the cell-sorted arrays of a :class:`~.devicehash.DeviceGridHash`:

    out[i] = min(labels[i], min{labels[j] : j in a neighbour cell of i,
                                r2(i, j) <= ll2})   for a valid query i

and ``labels[i]`` for an invalid one. Positions and cells do not change
between sweeps, so ``csrc/fof_sweep.cu`` does the neighbour search once
per FOF where it can:

- :func:`column_table`, built once per FOF in torch: the first sorted
  slot of every (a, b) column of cells. A query reads 9 columns from it
  (4.6 MB at 1077^3 cells: it stays in L2) and searches only inside a
  column, instead of 27 binary searches into all n ids.
- ``fof_link_count`` and ``fof_link_fill``, once per FOF: the pair test
  over those columns, counting then writing each valid query's linked
  ``j != i`` (int32) into a CSR list whose row offsets (int64) are the
  cumsum of the counts; the list is sorted within each row. A thread
  takes a query, as the search sweep does.
- ``fof_sweep`` in one of two modes. ``links``: a min over the list's
  rows, bound by bytes (16 a particle, 4 a link and the label it
  gathers), with no search. ``search``: the column lookups and the pair
  test in every sweep, bound by the latency of the column searches; it
  needs no list. :func:`.devicehash.fof_fixpoint` counts the links and
  takes ``links`` when the list fits the device's free memory beside
  the fixpoint's label arrays, ``search`` otherwise.

Every kernel reads the sweep's input labels and writes a new array (a
Jacobi sweep), so each mode equals :func:`fof_sweep_plain` bit for bit.

The plain versions: :func:`fof_sweep_plain` is the JAX package's fold
written in torch (per offset the (start, count) tables by
``searchsorted``, then a loop over slots up to that offset's largest
referenced cell, one host sync per offset), and the yardstick of both
modes. :func:`fof_pairs_plain` runs the same loop emitting the linked
pairs, sorted by (i, j); :func:`fof_link_count_plain` and
:func:`fof_link_fill_plain` read the count and the list off it, and
:func:`fof_links_sweep_plain` is a ``scatter_reduce('amin')`` over the
list. They write ``r2`` as ``(dx*dx + dy*dy) + dz*dz``, the kernels'
order.
"""

import ctypes

import numpy as np
import torch

from .gridhash import offset_candidates

# threads a block of each kernel (csrc/fof_sweep.cu SWEEP_THREADS)
SWEEP_THREADS = 256
# neighbour offsets a sweep takes: the 3 x 3 x 3 of ops/gridhash.py
MAX_OFFSETS = 27


def _check_args(pos_s, ci_s, flat_s, valid_s, n, offsets):
    if pos_s.shape != (n, 3) or ci_s.shape != (n, 3) \
            or flat_s.shape != (n,) or valid_s.shape != (n,):
        raise ValueError("shapes: pos %s, ci %s, flat %s, valid %s for %d "
                         "queries" % (tuple(pos_s.shape), tuple(ci_s.shape),
                                      tuple(flat_s.shape),
                                      tuple(valid_s.shape), n))
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError("1 to %d neighbour offsets, got %d"
                         % (MAX_OFFSETS, len(offsets)))


def axis_offsets(offsets):
    """(dlo, dhi): per axis the least and greatest offset, for offsets
    that are the product of one run of consecutive values in [-1, 1]
    per axis containing 0, as ``ops/gridhash.neighbor_offsets`` gives;
    raises on any other set (the kernels visit exactly that product).
    Cached by the set: every launch reads it, and the check costs ~0.1
    ms of host time."""
    key = tuple(map(tuple, offsets))
    if key not in _AXIS_OFFSETS:
        _AXIS_OFFSETS[key] = _axis_offsets(offsets)
    dlo, dhi = _AXIS_OFFSETS[key]
    return list(dlo), list(dhi)


_AXIS_OFFSETS = {}


def _axis_offsets(offsets):
    offs = np.asarray(offsets, dtype='i8').reshape(-1, 3)
    dlo, dhi = offs.min(axis=0), offs.max(axis=0)
    if (dlo < -1).any() or (dlo > 0).any() or (dhi < 0).any() \
            or (dhi > 1).any():
        raise ValueError("offsets outside [-1, 1] or without 0: %s"
                         % offsets)
    grid = np.stack(np.meshgrid(*[np.arange(a, b + 1)
                                  for a, b in zip(dlo, dhi)],
                                indexing='ij'), -1).reshape(-1, 3)
    if sorted(map(tuple, offs.tolist())) != sorted(map(tuple,
                                                       grid.tolist())):
        raise ValueError("offsets are not a product of per-axis runs: %s"
                         % offsets)
    return [int(v) for v in dlo], [int(v) for v in dhi]


def column_table(flat_s, ncell):
    """(nc0 * nc1 + 1,) int32: entry a * nc1 + b is the first slot of
    column (a, b) in the sorted cell ids ``flat_s`` (``searchsorted`` of
    ``(a * nc1 + b) * nc2``); the last entry is the first slot past every
    live cell (the dead slots' sentinel id is ``nc0 * nc1 * nc2``). On
    the ids' device; built once per FOF."""
    nc0, nc1, nc2 = (int(v) for v in ncell)
    if flat_s.shape[0] >= 2 ** 31:
        raise ValueError("the column table holds int32 slots; n = %d"
                         % flat_s.shape[0])
    keys = torch.arange(nc0 * nc1 + 1, dtype=flat_s.dtype,
                        device=flat_s.device) * nc2
    return torch.searchsorted(flat_s, keys, out_int32=True)


def fof_sweep_plain(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell,
                    box, ll2, periodic):
    """One Jacobi min-label sweep in torch, on any device.

    pos_s : (n, 3) f4/f8 sorted positions; ci_s : (n, 3) int32 cell
    coordinates; flat_s : (n,) int32/int64 sorted cell ids; valid_s :
    (n,) bool; labels : (n,) int32; offsets : neighbour offset triples;
    ncell : (3,) cells per axis; box : (3,) f8 box; ll2 : the squared
    linking length (cast to the positions' dtype, as is ``box``);
    periodic : minimum-image distances. Returns (n,) int32."""
    _check_args(pos_s, ci_s, flat_s, valid_s, labels.shape[0], offsets)
    best = labels.clone()
    if labels.shape[0] == 0:
        return best
    ll2_t = torch.tensor(float(ll2), dtype=pos_s.dtype, device=pos_s.device)
    for j, ok, _, r2 in offset_candidates(pos_s, flat_s, pos_s, ci_s,
                                          offsets, ncell, box, periodic):
        ok = ok & valid_s & (r2 <= ll2_t)
        best = torch.minimum(best, torch.where(ok, labels[j], best))
    return best


def fof_pairs_plain(pos_s, ci_s, flat_s, valid_s, offsets, ncell, box, ll2,
                    periodic):
    """(i, j), int64: every linked pair of the plain fold (a valid query
    i, a slot j != i of one of its neighbour cells, r2 <= ll2), sorted
    by i, then j. Arguments as :func:`fof_sweep_plain`."""
    n = pos_s.shape[0]
    _check_args(pos_s, ci_s, flat_s, valid_s, n, offsets)
    dev = pos_s.device
    ll2_t = torch.tensor(float(ll2), dtype=pos_s.dtype, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    keys = []
    if n:
        for j, ok, _, r2 in offset_candidates(pos_s, flat_s, pos_s, ci_s,
                                              offsets, ncell, box, periodic):
            ok = ok & valid_s & (r2 <= ll2_t) & (j != idx)
            keys.append(idx[ok] * n + j[ok])
    keys = torch.sort(torch.cat(keys))[0] if keys else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    return keys // max(n, 1), keys % max(n, 1)


def fof_link_count_plain(pos_s, ci_s, flat_s, valid_s, offsets, ncell, box,
                         ll2, periodic):
    """(n,) int32: the links of each query (:func:`fof_pairs_plain`)."""
    i, _ = fof_pairs_plain(pos_s, ci_s, flat_s, valid_s, offsets, ncell,
                           box, ll2, periodic)
    return torch.bincount(i, minlength=pos_s.shape[0]).to(torch.int32)


def fof_link_fill_plain(pos_s, ci_s, flat_s, valid_s, row, offsets, ncell,
                        box, ll2, periodic):
    """(E,) int32: the linked slots j of every query, row by row (the
    CSR list of row offsets ``row``, (n + 1,) int64), sorted within each
    row (:func:`fof_pairs_plain`)."""
    i, j = fof_pairs_plain(pos_s, ci_s, flat_s, valid_s, offsets, ncell,
                           box, ll2, periodic)
    if int(row[-1]) != j.shape[0]:
        raise ValueError("row offsets hold %d links, the pairs %d"
                         % (int(row[-1]), j.shape[0]))
    return j.to(torch.int32)


def fof_links_sweep_plain(row, links, labels):
    """One Jacobi sweep over a CSR link list: ``out[i] = min(labels[i],
    min labels[links[row[i]:row[i + 1]]])``, by ``scatter_reduce``."""
    n = labels.shape[0]
    if row.shape != (n + 1,) or links.shape != (int(row[-1]),):
        raise ValueError("row %s and links %s for %d labels"
                         % (tuple(row.shape), tuple(links.shape), n))
    owner = torch.repeat_interleave(
        torch.arange(n, device=labels.device), row[1:] - row[:-1])
    return labels.clone().scatter_reduce(0, owner, labels[links.long()],
                                         'amin')


_fns = {}


def grid_argtypes(name):
    """ctypes argument types of a column-table kernel's entry point
    (``nbk_fof_sweep``, ``nbk_fof_link_count``, ``nbk_fof_link_fill``):
    pos, ci, flat, valid, cols, then labels and out (sweep), counts
    (count) or row and links (fill); n, pos bytes, key bytes; dlo, dhi,
    ncell, box; ll2, periodic, stream."""
    ptrs = 6 if name == 'nbk_fof_link_count' else 7
    return ([ctypes.c_void_p] * ptrs
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])


def _fn(name):
    if name not in _fns:
        from .._build import load
        fn = getattr(load('fof_sweep'), name)
        if name == 'nbk_fof_links_sweep':
            # row, links, labels, out; n, stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
        else:
            fn.argtypes = grid_argtypes(name)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_cuda(who, tensors):
    if not all(isinstance(t, torch.Tensor) and t.device.type == 'cuda'
               for t in tensors):
        raise ValueError("%s takes CUDA tensors" % who)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("%s takes tensors on one device" % who)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s takes contiguous tensors" % who)


def grid_launch_args(pos_s, ci_s, flat_s, valid_s, cols, a, b, offsets,
                     ncell, box, ll2, periodic):
    """The C arguments of one launch of a column-table kernel writing
    ``b`` (``a``: the sweep's labels, the fill's row offsets, or None),
    for :func:`grid_argtypes`; the caller keeps the tensors alive."""
    dlo, dhi = axis_offsets(offsets)
    ints = ctypes.c_int * 3
    stream = torch.cuda.current_stream(pos_s.device).cuda_stream
    ptrs = [t.data_ptr() for t in (pos_s, ci_s, flat_s, valid_s, cols, a, b)
            if t is not None]
    return (*ptrs, pos_s.shape[0], pos_s.element_size(),
            flat_s.element_size(), ints(*dlo), ints(*dhi),
            ints(*[int(v) for v in ncell]),
            (ctypes.c_double * 3)(*[float(v) for v in box]), float(ll2),
            int(bool(periodic)), stream)


def _grid_call(who, name, pos_s, ci_s, flat_s, valid_s, cols, a, b,
               offsets, ncell, box, ll2, periodic):
    """Checks, then one launch of a column-table kernel (search sweep,
    link count or link fill) writing ``b``."""
    from .._build import check
    n = pos_s.shape[0]
    _check_cuda(who, (pos_s, ci_s, flat_s, valid_s, cols, b)
                + ((a,) if a is not None else ()))
    _check_args(pos_s, ci_s, flat_s, valid_s, n, offsets)
    if pos_s.dtype not in (torch.float32, torch.float64) \
            or ci_s.dtype != torch.int32 \
            or flat_s.dtype not in (torch.int32, torch.int64) \
            or valid_s.dtype != torch.bool or cols.dtype != torch.int32:
        raise ValueError("dtypes: pos f4/f8, ci int32, flat int32/int64, "
                         "valid bool, cols int32; got %s"
                         % [str(t.dtype) for t in (pos_s, ci_s, flat_s,
                                                   valid_s, cols)])
    if n >= 2 ** 31:
        raise ValueError("%s takes n < 2**31, got %d" % (who, n))
    if cols.shape != (int(ncell[0]) * int(ncell[1]) + 1,):
        raise ValueError("column table %s for cells %s"
                         % (tuple(cols.shape), list(ncell)))
    if n == 0:
        return
    check('fof_sweep', _fn(name)(*grid_launch_args(
        pos_s, ci_s, flat_s, valid_s, cols, a, b, offsets, ncell, box, ll2,
        periodic)))


def fof_sweep_cuda(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell,
                   box, ll2, periodic, cols=None):
    """One search-mode sweep on the CUDA kernel (``fof_search_kernel``):
    the contract of :func:`fof_sweep_plain`, bit-identical output.
    ``cols`` is the grid's :func:`column_table` (built here if None).
    All tensors contiguous on one CUDA device, n < 2**31."""
    _check_cuda('fof_sweep_cuda', (pos_s, ci_s, flat_s, valid_s, labels))
    if labels.dtype != torch.int32 or labels.shape != (pos_s.shape[0],):
        raise ValueError("labels: (%d,) int32, got %s %s"
                         % (pos_s.shape[0], tuple(labels.shape),
                            labels.dtype))
    if cols is None:
        cols = column_table(flat_s, ncell)
    out = torch.empty_like(labels)
    _grid_call('fof_sweep_cuda', 'nbk_fof_sweep', pos_s, ci_s, flat_s,
               valid_s, cols, labels, out, offsets, ncell, box, ll2,
               periodic)
    if labels.shape[0]:
        fof_sweep_cuda.launches += 1
    return out


fof_sweep_cuda.launches = 0


def fof_link_count_cuda(pos_s, ci_s, flat_s, valid_s, cols, offsets, ncell,
                        box, ll2, periodic):
    """(n,) int32 link counts on the CUDA kernel
    (``fof_link_count_kernel``), equal to :func:`fof_link_count_plain`."""
    _check_cuda('fof_link_count_cuda', (pos_s, ci_s, flat_s, valid_s, cols))
    counts = torch.empty(pos_s.shape[0], dtype=torch.int32,
                         device=pos_s.device)
    _grid_call('fof_link_count_cuda', 'nbk_fof_link_count', pos_s, ci_s,
               flat_s, valid_s, cols, None, counts, offsets, ncell, box,
               ll2, periodic)
    if pos_s.shape[0]:
        fof_link_count_cuda.launches += 1
    return counts


fof_link_count_cuda.launches = 0


def fof_link_fill_cuda(pos_s, ci_s, flat_s, valid_s, cols, row, offsets,
                       ncell, box, ll2, periodic, nlinks=None):
    """(E,) int32 link list on the CUDA kernel (``fof_link_fill_kernel``)
    for the row offsets ``row`` ((n + 1,) int64, the cumsum of
    :func:`fof_link_count_cuda`'s counts), equal to
    :func:`fof_link_fill_plain`. ``nlinks``, E where the caller has
    read it, spares a read of ``row[-1]`` (a host sync)."""
    _check_cuda('fof_link_fill_cuda', (pos_s, ci_s, flat_s, valid_s, cols,
                                       row))
    n = pos_s.shape[0]
    if row.dtype != torch.int64 or row.shape != (n + 1,):
        raise ValueError("row: (%d,) int64, got %s %s"
                         % (n + 1, tuple(row.shape), row.dtype))
    if nlinks is None:
        nlinks = int(row[-1])
    links = torch.empty(nlinks, dtype=torch.int32, device=row.device)
    _grid_call('fof_link_fill_cuda', 'nbk_fof_link_fill', pos_s, ci_s,
               flat_s, valid_s, cols, row, links, offsets, ncell, box, ll2,
               periodic)
    if n:
        fof_link_fill_cuda.launches += 1
    return links


fof_link_fill_cuda.launches = 0


def fof_links_sweep_cuda(row, links, labels):
    """One links-mode sweep on the CUDA kernel
    (``fof_links_sweep_kernel``), equal to :func:`fof_links_sweep_plain`
    and to :func:`fof_sweep_plain` on the list's grid."""
    from .._build import check
    _check_cuda('fof_links_sweep_cuda', (row, links, labels))
    n = labels.shape[0]
    if row.dtype != torch.int64 or row.shape != (n + 1,) \
            or links.dtype != torch.int32 or labels.dtype != torch.int32:
        raise ValueError("row (%d,) int64, links int32, labels int32; got "
                         "%s %s, %s, %s" % (n + 1, tuple(row.shape),
                                            row.dtype, links.dtype,
                                            labels.dtype))
    if n >= 2 ** 31:
        raise ValueError("fof_links_sweep_cuda takes n < 2**31, got %d" % n)
    out = torch.empty_like(labels)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    check('fof_sweep', _fn('nbk_fof_links_sweep')(
        row.data_ptr(), links.data_ptr(), labels.data_ptr(), out.data_ptr(),
        n, stream))
    fof_links_sweep_cuda.launches += 1
    return out


fof_links_sweep_cuda.launches = 0


def _device_of(t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError("no FOF sweep for device %s" % t.device)
    return t.device.type


def fof_sweep(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell, box,
              ll2, periodic, cols=None):
    """One search-mode sweep dispatched on the labels' device: the plain
    version for a CPU tensor, the CUDA kernel (with the column table
    ``cols``) for a CUDA tensor."""
    if _device_of(labels) == 'cpu':
        return fof_sweep_plain(pos_s, ci_s, flat_s, valid_s, labels,
                               offsets, ncell, box, ll2, periodic)
    return fof_sweep_cuda(pos_s, ci_s, flat_s, valid_s, labels, offsets,
                          ncell, box, ll2, periodic, cols)


def fof_link_count(pos_s, ci_s, flat_s, valid_s, cols, offsets, ncell, box,
                   ll2, periodic):
    """Link counts on the positions' device (``cols`` is read only by
    the CUDA kernel)."""
    if _device_of(pos_s) == 'cpu':
        return fof_link_count_plain(pos_s, ci_s, flat_s, valid_s, offsets,
                                    ncell, box, ll2, periodic)
    return fof_link_count_cuda(pos_s, ci_s, flat_s, valid_s, cols, offsets,
                               ncell, box, ll2, periodic)


def fof_link_fill(pos_s, ci_s, flat_s, valid_s, cols, row, offsets, ncell,
                  box, ll2, periodic, nlinks=None):
    """The link list on the positions' device (``nlinks``: E, if
    known)."""
    if _device_of(pos_s) == 'cpu':
        return fof_link_fill_plain(pos_s, ci_s, flat_s, valid_s, row,
                                   offsets, ncell, box, ll2, periodic)
    return fof_link_fill_cuda(pos_s, ci_s, flat_s, valid_s, cols, row,
                              offsets, ncell, box, ll2, periodic, nlinks)


def fof_links_sweep(row, links, labels):
    """One links-mode sweep on the labels' device."""
    if _device_of(labels) == 'cpu':
        return fof_links_sweep_plain(row, links, labels)
    return fof_links_sweep_cuda(row, links, labels)


def sweep_bytes(n, pos_itemsize, key_itemsize):
    """Bytes one search-mode sweep must move: the sorted positions, cell
    coordinates, cell ids, valid flags and labels read once, the labels
    written once (the column table is :func:`column_bytes`)."""
    return int(n) * (3 * pos_itemsize + 3 * 4 + key_itemsize + 1 + 4 + 4)


def column_bytes(ncell):
    """Bytes of the column table: 4 an entry, nc0 * nc1 + 1 entries."""
    return 4 * (int(ncell[0]) * int(ncell[1]) + 1)


def link_table_entries(ci_s, searching, ncell, offsets, periodic):
    """Column-table entries a link kernel must read for the queries
    ``searching`` ((n,) bool) of cells ``ci_s`` ((n, 3) int32): the first
    slot of each of their neighbour columns and the one past it, counted
    once (an int; one host sync). On a sparse grid that is far less than
    the table: FiberCollisions' points on a sphere reach a disk of its
    4096^2 columns."""
    nc0, nc1 = int(ncell[0]), int(ncell[1])
    dlo, dhi = axis_offsets(offsets)
    a = ci_s[searching, 0].long()
    b = ci_s[searching, 1].long()
    read = torch.zeros(nc0 * nc1 + 1, dtype=torch.bool, device=ci_s.device)
    for da in range(dlo[0], dhi[0] + 1):
        for db in range(dlo[1], dhi[1] + 1):
            va, vb = a + da, b + db
            if periodic:
                va, vb = va.remainder(nc0), vb.remainder(nc1)
                col = va * nc1 + vb
            else:
                col = (va * nc1 + vb)[(va >= 0) & (va < nc0) & (vb >= 0)
                                      & (vb < nc1)]
            read[col] = True
            read[col + 1] = True
    return int(read.sum())


def link_count_bytes(n, pos_itemsize, key_itemsize, entries):
    """Bytes the link count must move: positions, cell coordinates, ids
    and flags read once, the ``entries`` column-table entries it reaches
    (:func:`link_table_entries`) once, the counts written once."""
    return int(n) * (3 * pos_itemsize + 3 * 4 + key_itemsize + 1 + 4) \
        + 4 * int(entries)


def link_fill_bytes(n, links, pos_itemsize, key_itemsize, entries):
    """Bytes the link fill must move: the count's inputs (the ``entries``
    reached by the queries with a link) and the row offsets read once,
    the links written once."""
    return int(n) * (3 * pos_itemsize + 3 * 4 + key_itemsize + 1) \
        + 8 * (int(n) + 1) + 4 * int(entries) + 4 * int(links)


def links_sweep_bytes(n, links):
    """Bytes one links-mode sweep must move: the row offsets, labels and
    links read once, the labels written once."""
    return 8 * (int(n) + 1) + 4 * int(n) + 4 * int(links) + 4 * int(n)


def fixpoint_bytes(n, sweeps, pos_itemsize, key_itemsize):
    """The least bytes of a whole fixpoint of ``sweeps`` sweeps: the
    positions, cell coordinates, ids and flags read once, and the labels
    read and written once a sweep (29 + 8 * sweeps bytes a particle at
    f32 with int32 ids)."""
    return int(n) * (3 * pos_itemsize + 3 * 4 + key_itemsize + 1
                     + 8 * int(sweeps))
