"""Binned pair counts on the grid hash: the Hopper kernel and its plain
version.

Computes the neighbour fold of the JAX package's pair counting
(``nbodykit_tpu/algorithms/pair_counters/core.py:103-151``, ``_fold_body``
under ``GridHash.fold``), which XLA runs as gathers and bincounts over
every (offset, slot) candidate (no Pallas kernel): for every live query
``i`` and every candidate ``j`` of its neighbour cells,

    dn = pos_s[j] - p1[i] (minimum image when periodic), d = -dn,
    r2 = (dx*dx + dy*dy) + dz*dz,
    ok = (r2 > 0 if is_auto else r2 >= 0), and for 'projected' dlos < pimax,
    npairs[row * nb2 + col] += ok, wpairs[row * nb2 + col] += w1[i] w2[j] ok

with ``row = digitize(r2, r2edges)`` (of ``rp2 = r2 - dlos^2`` for
'projected'), ``col`` the mu bin ('2d') or the pi bin ('projected'), 0
for '1d' and 'angular'; ``dlos = |d[los]|``, or ``|d . mid| / |mid|``
with ``mid = 0.5 (p1 + p2) + origin`` for the 'midpoint' line of sight.
Both histograms are flat, ``(nb1 + 2) * nb2`` long, f64 (``npairs`` of
exact integer counts), rows 0 and ``nb1 + 1`` the pairs outside the
edges, as the JAX bincounts leave them.

:func:`paircount_hist_plain` is that fold in torch on
:meth:`.devicehash.DeviceGridHash.fold`, in blocks of slots;
:func:`paircount_hist_cuda` launches ``csrc/paircount.cu`` (a CTA an item
of queries of one cell, a thread a query, the cell's candidates staged in
shared memory, the bin by one compare at each end and a bucket table,
privatised histograms; an auto count of the grid's own points counts each
pair once and doubles). :func:`paircount_hist` dispatches on the queries'
device. The host-side pieces of the kernel's design are here and tested
on the CPU: the bin table (:func:`bin_table`, :func:`table_digitize`),
the items (:func:`query_items`) and the shared-memory plan
(:func:`smem_bytes`).
"""

import ctypes

import numpy as np
import torch

# threads a CTA of the kernel, and queries an item (csrc/paircount.cu
# PC_THREADS)
PC_THREADS = 128
# entries of the largest bin table (csrc/paircount.cu PC_TAB_MAX)
PC_TAB_MAX = 1024
# the modes of the kernel (csrc/paircount.cu MODE_*)
MODES = {'1d': 0, 'angular': 0, '2d': 1, 'projected': 2}
# dynamic shared memory a CTA may take on sm_90
SMEM_LIMIT = 232448
# queries, and slots per offset, a step of the plain fold
PLAIN_CHUNK = 4096
PLAIN_BLOCK = 32


def hist_bins(nedges, nb2):
    """Length of the flat histograms: (nb1 + 2) * nb2."""
    return (int(nedges) + 1) * int(nb2)


def private_rows(mode, nedges, nb2):
    """Rows of a thread's private histogram in the kernel: '1d' and
    'angular' rows 0..nb1 (the overflow row is in registers), '2d' the
    nb2 columns of the overflow row, 'projected' none."""
    return {0: int(nedges), 1: int(nb2), 2: 0}[MODES[mode]]


def smem_bytes(mode, nedges, nb2, tab_len):
    """Shared memory of one CTA of the kernel: the two staged tiles (32
    bytes a candidate), the edges, the CTA's totals (16 bytes a bin), the
    shared histogram ('2d', 'projected': 12 bytes a bin), the threads'
    private rows (8 bytes a row a thread, their counts 4 bytes a row a
    warp), the runs and the device bin table (``tab_len`` entries of 16
    bytes, :func:`device_table`)."""
    nbins = hist_bins(nedges, nb2)
    b = 2 * PC_THREADS * 32 + 16 * int(tab_len) + 8 * int(nedges) \
        + 16 * nbins
    if MODES[mode] != 0:
        b += 12 * nbins
    b += private_rows(mode, nedges, nb2) * (8 * PC_THREADS
                                            + 4 * (PC_THREADS // 32))
    return b + 3 * 18 * 4


def _bits(x):
    return np.asarray(x, dtype='f8').view('i8')


def bin_table(r2edges, cap=PC_TAB_MAX):
    """The kernels' bucket table of increasing edges (``csrc/
    grid_columns.cuh`` table_digitize): (tab, shift, base). A positive
    double's bits order as its value, so bucket ``k = (bits(x) >> shift)
    - base`` of x grows with x; ``base`` is the bucket of the smallest
    positive edge, and ``tab[k]`` (int16) the number of edges <= the
    bucket's least value. ``shift`` is the largest that leaves at most
    one edge inside any bucket (a walk of one step: :func:`table_steps`),
    within ``cap`` entries."""
    e = np.asarray(r2edges, dtype='f8')
    if len(e) >= 2 ** 15:
        raise ValueError("at most 32767 edges")
    posv = e[e > 0]
    if len(posv) == 0 or posv[0] >= e[-1]:
        # no bucket is ever looked up (x < the first positive edge)
        return np.ones(1, dtype='i2'), 52, int(_bits(e[-1]) >> 52)
    lo, top = _bits(posv[0]), _bits(e[-1])
    best = None
    for frac in range(-10, 53):
        shift = 52 - frac
        base = int(lo >> shift)
        n = int(top >> shift) - base + 1
        if n > cap:
            break
        starts = ((np.arange(n, dtype='i8') + base) << shift).view('f8')
        best = (np.searchsorted(e, starts, side='right').astype('i2'), shift,
                base)
        if _inside(e, *best).max() <= 1:
            break
    return best


def _inside(e, tab, shift, base):
    """Per bucket of the table, the edges past its guess below the next
    bucket."""
    starts = ((np.arange(len(tab), dtype='i8') + int(base))
              << int(shift)).view('f8')
    nxt = np.append(starts[1:], np.inf)
    return np.searchsorted(e, nxt, side='left') - np.asarray(tab, 'i8')


def table_steps(r2edges, tab, shift, base):
    """The most edges the kernels' walk passes after the table's guess:
    inside a bucket, or below the first bucket (from 1, when e[0] is 0).
    The kernels take one compare, no loop, where it is at most 1."""
    e = np.asarray(r2edges, dtype='f8')
    posv = e[e > 0]
    below = int((e < posv[0]).sum()) - 1 if len(posv) else 0
    return int(max(below, _inside(e, tab, shift, base).max(), 0))


def device_table(r2edges, tab):
    """The kernels' table (``csrc/grid_columns.cuh`` table_digitize): an
    (len(tab) + 1, 4) int32 array, entry k + 1 the bucket's guess g and
    e[g] (+inf past the last edge) as the two int32 halves of its f64,
    entry 0 the guess 1 below the first bucket: one 16-byte load gives
    the guess and the edge its one-step walk compares."""
    e = np.append(np.asarray(r2edges, dtype='f8'), np.inf)
    g = np.concatenate([[1], np.asarray(tab, dtype='i8')])
    out = np.zeros((len(g), 4), dtype='i4')
    out[:, 0] = g
    out[:, 2:] = np.ascontiguousarray(e[g]).view('i4').reshape(-1, 2)
    return out


def table_digitize(e, tab, shift, base, x):
    """A torch model of the kernels' lookup: np.digitize(x, e) for x in
    [e[0], e[-1]) (f64 tensors; ``tab`` from :func:`bin_table`), the
    walk up taken by every element until none moves."""
    tab = torch.as_tensor(np.asarray(tab, dtype='i8'), device=x.device)
    k = (x.view(torch.int64) >> int(shift)) - int(base)
    g = torch.where(k < 0, torch.ones_like(k),
                    tab[torch.clamp(k, 0, tab.numel() - 1)])
    while True:
        step = (e[g] <= x).to(torch.int64)
        if not bool(step.any()):
            return g
        g = g + step


def row_of(e, tab, shift, base, x):
    """The kernels' row of x among the edges e: 0 below e[0], len(e) from
    e[-1] on (and NaN), else :func:`table_digitize`."""
    nb1 = e.numel() - 1
    inside = (x >= e[0]) & (x < e[nb1])
    xs = torch.where(inside, x, e[0])
    g = table_digitize(e, tab, shift, base, xs)
    return torch.where(inside, g, torch.where(x < e[0], 0, nb1 + 1))


def query_items(flat, per):
    """The items of the kernels (csrc/paircount.cu, csrc/threept_alm.cu):
    runs of at most ``per`` consecutive queries with one cell id
    ``flat``, as (items, max_items): ``items`` int32 of max_items + 2,
    entry i the first query of item i, m past the last item (entry
    max_items + 1 a scratch slot); ``max_items`` = m bounds their number
    in any query order without a host sync. Queries in the grid's cell
    order make ceil(m / per) full items and at most one partial item a
    cell."""
    m = int(flat.shape[0])
    dev = flat.device
    bound = max(m, 1)
    items = torch.full((bound + 2,), m, dtype=torch.int32, device=dev)
    if m == 0:
        return items, bound
    q = torch.arange(m, dtype=torch.int64, device=dev)
    new = torch.ones(m, dtype=torch.bool, device=dev)
    new[1:] = flat[1:] != flat[:-1]
    # each query's run of one cell id, and the run's first query
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    start = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    start.scatter_(0, torch.where(new, run, m), q)
    first = (q - start[run]) % int(per) == 0
    idx = torch.cumsum(first.to(torch.int64), 0) - 1
    items.scatter_(0, torch.where(first, idx, bound + 1), q.to(torch.int32))
    items[bound + 1] = m
    return items, bound


def _check_mode(mode, nb2, pimax, los):
    if mode not in MODES:
        raise ValueError("unknown mode %r" % (mode,))
    if int(nb2) < 1:
        raise ValueError("nb2 must be >= 1, got %r" % (nb2,))
    if mode == 'projected' and pimax is None:
        raise ValueError("mode 'projected' needs pimax")
    if los != 'midpoint' and los not in (0, 1, 2):
        raise ValueError("los is an axis (0, 1, 2) or 'midpoint', got %r"
                         % (los,))


def _fold_body(grid, w2_s, e, mode, nb1, nb2, pimax, los, origin, is_auto,
               p1c, w1c, live1):
    """The JAX package's ``_fold_body`` in torch, for blocks of slots:
    (npairs, wpairs) += the candidates' bincounts."""
    nbins = (nb1 + 2) * nb2
    p = p1c[:, None, :]

    def body(carry, j, valid, dneg, r2):
        npairs, wpairs = carry
        d = -dneg
        ok = live1[:, None] & valid & ((r2 > 0) if is_auto else (r2 >= 0))
        dig_r = torch.bucketize(r2, e, right=True)
        if los == 'midpoint' and mode in ('2d', 'projected'):
            mid = 0.5 * (p + grid.pos_s[j]) + origin
            mnorm = torch.sqrt((mid[..., 0] * mid[..., 0]
                                + mid[..., 1] * mid[..., 1])
                               + mid[..., 2] * mid[..., 2])
            dot = (d[..., 0] * mid[..., 0] + d[..., 1] * mid[..., 1]) \
                + d[..., 2] * mid[..., 2]
            dlos = torch.abs(dot) / torch.where(mnorm == 0, 1.0, mnorm)
        elif mode in ('2d', 'projected'):
            dlos = torch.abs(d[..., los])
        if mode == '2d':
            rr = torch.sqrt(torch.where(r2 == 0, 1.0, r2))
            mu = torch.where(r2 == 0, 0.0, dlos / rr)
            dig_2 = torch.clamp((mu * nb2).to(torch.int64), 0, nb2 - 1)
        elif mode == 'projected':
            dig_r = torch.bucketize(r2 - dlos * dlos, e, right=True)
            dig_2 = torch.clamp(dlos.to(torch.int64), 0, nb2 - 1)
            ok = ok & (dlos < pimax)
        else:
            dig_2 = 0
        idx = torch.where(ok, dig_r * nb2 + dig_2, (nb1 + 1) * nb2)
        wts = torch.where(ok, w1c[:, None] * w2_s[j], 0.0)
        npairs = npairs + torch.bincount(idx.reshape(-1),
                                         weights=ok.reshape(-1).double(),
                                         minlength=nbins)
        wpairs = wpairs + torch.bincount(idx.reshape(-1),
                                         weights=wts.reshape(-1),
                                         minlength=nbins)
        return npairs, wpairs

    return body


def paircount_hist_plain(grid, w2_s, p1, w1, live1, ci1, r2edges, mode,
                         nb2=1, pimax=None, los=2, origin=None,
                         is_auto=False, block=PLAIN_BLOCK):
    """The pair-count histograms in torch, on any device.

    grid : a :class:`.devicehash.DeviceGridHash` of f64 secondaries;
    w2_s : (n2,) f64 weights in the grid's sorted order; p1 : (m, 3) f64
    queries; w1 : (m,) f64; live1 : (m,) bool; ci1 : (m, 3) int32 query
    cells (``grid.cell_of(p1)``); r2edges : (nb1 + 1,) f64 squared
    edges, increasing; mode : '1d', '2d', 'projected' or 'angular'; nb2 :
    mu or pi bins; pimax : 'projected' only; los : axis or 'midpoint';
    origin : (3,) f64 added to the midpoint (the observer at the
    coordinate origin before the grid's shift); is_auto : drop every
    pair with r2 == 0. Every query counts every candidate, as the JAX
    fold does. Returns (npairs, wpairs), flat (nb1 + 2) * nb2 f64
    tensors. Queries go :data:`PLAIN_CHUNK` at a time, slots ``block``
    at a time."""
    _check_mode(mode, nb2, pimax, los)
    dev = p1.device
    e = torch.as_tensor(r2edges, dtype=torch.float64, device=dev)
    nb1 = e.numel() - 1
    nbins = hist_bins(e.numel(), nb2)
    org = torch.as_tensor(np.zeros(3) if origin is None
                          else np.array(origin, 'f8'),
                          dtype=torch.float64, device=dev)
    carry = (torch.zeros(nbins, dtype=torch.float64, device=dev),
             torch.zeros(nbins, dtype=torch.float64, device=dev))
    for c0 in range(0, p1.shape[0], PLAIN_CHUNK):
        sl = slice(c0, c0 + PLAIN_CHUNK)
        body = _fold_body(grid, w2_s, e, mode, nb1, int(nb2), pimax, los,
                          org, is_auto, p1[sl], w1[sl], live1[sl])
        carry = grid.fold(p1[sl], ci1[sl], body, carry, block=block)
    return carry


# pos, w2, flat, cols; n2, key bytes; p1, w1, live, ci; n1; r2edges; nb1,
# nb2, mode, los; origin; pimax; is_auto, periodic; dlo, dhi, ncell, box;
# out_n, out_w; items, max items; bin table, its length, shift, base and
# steps; each pair once (:func:`each_pair_once`) and the flag that every
# query is live; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_double] + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)

_fns = {}


def _fn():
    if 'hist' not in _fns:
        from .._build import load
        fn = load('paircount').nbk_paircount_hist
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns['hist'] = fn
    return _fns['hist']


_TABLES = {}


def edges_and_table(r2edges, device):
    """The squared edges on ``device`` (f64, contiguous) and their bin
    table (:func:`device_table` of :func:`bin_table`, on the device), made
    from a host copy (an array's own, no sync): (e, tab, shift, base,
    steps). Kept for the edges and device last asked for, so that the
    counts of one flow, which share their edges, copy them once."""
    host = r2edges.cpu().numpy() if torch.is_tensor(r2edges) \
        else np.asarray(r2edges, dtype='f8')
    key = (str(device), host.tobytes())
    if key not in _TABLES:
        e = torch.as_tensor(host, dtype=torch.float64, device=device)
        tab, shift, base = bin_table(host)
        steps = table_steps(host, tab, shift, base)
        dev_tab = torch.as_tensor(device_table(host, tab), device=device)
        _TABLES.clear()
        _TABLES[key] = (e.contiguous(), dev_tab, shift, base, steps)
    return _TABLES[key]


def each_pair_once(grid, w2_s, p1, w1, is_auto):
    """Whether the kernel may count each pair once and double: an auto
    count whose queries are the grid's own points (``p1`` is
    ``grid.pos_s``, ``w1`` is ``w2_s``). It does so only if every query
    is live too, which it reads from a flag made on the card
    (:func:`launch_args`, no host sync): a dead query's pairs count once
    in the plain version, from their other end, so then the kernel
    visits every pair from both ends."""
    return bool(is_auto) and p1.data_ptr() == grid.pos_s.data_ptr() \
        and p1.shape == grid.pos_s.shape and p1.stride() == \
        grid.pos_s.stride() and w1.data_ptr() == w2_s.data_ptr() \
        and w1.shape == w2_s.shape


def launch_args(grid, w2_s, p1, w1, live1, ci1, r2edges, mode, nb2, pimax,
                los, origin, is_auto, out_n, out_w):
    """The arguments of ``nbk_paircount_hist`` (:data:`ARGTYPES`) for
    checked tensors and int64 / f64 outputs of :func:`hist_bins` zeros,
    and the tensors made here (the edges on the device, the items and the
    bin table): (args, keep). The caller keeps every tensor alive until
    the launch has run."""
    from .fof_cuda import axis_offsets
    dlo, dhi = axis_offsets(grid.offsets)
    ints = ctypes.c_int * 3
    dbls = ctypes.c_double * 3
    org = np.zeros(3) if origin is None else np.asarray(origin, 'f8')
    once = each_pair_once(grid, w2_s, p1, w1, is_auto)
    all_live = live1.all().to(torch.uint8) if once else None
    items, max_items = query_items(grid._flatten(ci1), PC_THREADS)
    e, tab, shift, base, steps = edges_and_table(r2edges, p1.device)
    args = (
        grid.pos_s.data_ptr(), w2_s.data_ptr(), grid.flat_s.data_ptr(),
        grid.columns().data_ptr(), grid.pos_s.shape[0],
        grid.flat_s.element_size(), p1.data_ptr(), w1.data_ptr(),
        live1.data_ptr(), ci1.data_ptr(), p1.shape[0], e.data_ptr(),
        e.numel() - 1, int(nb2), MODES[mode],
        -1 if los == 'midpoint' else int(los), dbls(*[float(v) for v in org]),
        float(pimax) if pimax is not None else 0.0, int(bool(is_auto)),
        int(bool(grid.periodic)), ints(*dlo), ints(*dhi),
        ints(*[int(v) for v in grid.ncell_np]),
        dbls(*[float(v) for v in grid.box_np]), out_n.data_ptr(),
        out_w.data_ptr(), items.data_ptr(), max_items, tab.data_ptr(),
        tab.shape[0], shift, base, steps, int(once),
        None if all_live is None else all_live.data_ptr(),
        torch.cuda.current_stream(p1.device).cuda_stream)
    return args, (e, items, tab, all_live)


def paircount_hist_cuda(grid, w2_s, p1, w1, live1, ci1, r2edges, mode,
                        nb2=1, pimax=None, los=2, origin=None,
                        is_auto=False):
    """The histograms on the CUDA kernel (``paircount_kernel``): the
    contract of :func:`paircount_hist_plain`, ``npairs`` equal to it,
    ``wpairs`` up to the order of the f64 sums. All tensors contiguous
    on one CUDA device, n < 2**31 on both sides; queries in the grid's
    cell order fill the kernel's items. An auto count of the grid's own
    points, every one live, counts each pair once and doubles
    (:func:`each_pair_once`)."""
    from .._build import check
    from .fof_cuda import _check_cuda
    _check_mode(mode, nb2, pimax, los)
    cols = grid.columns()
    m = p1.shape[0]
    n2 = grid.pos_s.shape[0]
    _check_cuda('paircount_hist_cuda', (grid.pos_s, w2_s, grid.flat_s, cols,
                                        p1, w1, live1, ci1))
    if grid.pos_s.dtype != torch.float64 or w2_s.dtype != torch.float64 \
            or p1.dtype != torch.float64 or w1.dtype != torch.float64 \
            or live1.dtype != torch.bool or ci1.dtype != torch.int32:
        raise ValueError("dtypes: positions and weights f64, live bool, "
                         "cells int32")
    if p1.shape != (m, 3) or w1.shape != (m,) or live1.shape != (m,) \
            or ci1.shape != (m, 3) or w2_s.shape != (n2,):
        raise ValueError("shapes: p1 %s, w1 %s, live %s, ci %s, w2 %s"
                         % (tuple(p1.shape), tuple(w1.shape),
                            tuple(live1.shape), tuple(ci1.shape),
                            tuple(w2_s.shape)))
    if m >= 2 ** 31 or n2 >= 2 ** 31:
        raise ValueError("paircount_hist_cuda takes n < 2**31")
    nedges = len(r2edges)
    if nedges < 2:
        raise ValueError("at least two edges")
    nbins = hist_bins(nedges, nb2)
    if smem_bytes(mode, nedges, nb2, PC_TAB_MAX + 1) > SMEM_LIMIT:
        raise ValueError("%d bins do not fit a CTA's shared memory" % nbins)
    out_n = torch.zeros(nbins, dtype=torch.int64, device=p1.device)
    out_w = torch.zeros(nbins, dtype=torch.float64, device=p1.device)
    if m == 0 or n2 == 0:
        return out_n.double(), out_w
    args, keep = launch_args(grid, w2_s, p1, w1, live1, ci1, r2edges, mode,
                             nb2, pimax, los, origin, is_auto, out_n, out_w)
    check('paircount', _fn()(*args))
    paircount_hist_cuda.launches += 1
    return out_n.double(), out_w


paircount_hist_cuda.launches = 0


def paircount_hist(grid, w2_s, p1, w1, live1, ci1, r2edges, mode, nb2=1,
                   pimax=None, los=2, origin=None, is_auto=False):
    """The histograms on the queries' device: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    if p1.device.type == 'cpu':
        return paircount_hist_plain(grid, w2_s, p1, w1, live1, ci1, r2edges,
                                    mode, nb2, pimax, los, origin, is_auto)
    if p1.device.type != 'cuda':
        raise ValueError("no pair count for device %s" % p1.device)
    return paircount_hist_cuda(grid, w2_s, p1, w1, live1, ci1, r2edges, mode,
                               nb2, pimax, los, origin, is_auto)


def candidate_ops(mode, los):
    """f64 operations of one visited candidate, the least the count
    needs: the difference (3), r2 (5), the compares at both ends of the
    edges (2), the weight's sum (1); '2d' adds mu's sqrt, division,
    product and its bin (4), 'projected' rp2 and its compares (5), the
    midpoint line of sight 21 more. The minimum image adds nothing where
    it leaves d as it is (csrc/grid_columns.cuh column_runs), and the
    table's walk inside the edges is not counted. The products w1 w2 are
    counted apart (:func:`weight_products`)."""
    ops = 3 + 5 + 2 + 1
    if mode == '2d':
        ops += 4
    elif mode == 'projected':
        ops += 5
    if mode in ('2d', 'projected') and los == 'midpoint':
        ops += 21
    return ops


def weight_products(visited, n1, nbins):
    """The products w1 w2 a weighted count needs, the fewer of two ways:
    one a visited candidate, or one a (query, bin) with the candidates'
    w2 summed in each bin first (as the kernel's '1d' rows do)."""
    return min(int(visited), int(n1) * int(nbins))


def visited_candidates(candidates, n, once):
    """The candidates the kernel visits: all of them, or where it counts
    each pair once (:func:`each_pair_once`, an auto count of the grid's
    own n points) (candidates - n) / 2 (the neighbour cells are symmetric
    and every point is its own candidate once)."""
    return (int(candidates) - int(n)) // 2 if once \
        else int(candidates)


def hist_bytes(n1, n2, key_bytes, ncols, nedges, nb2):
    """Bytes the kernel must move: the queries (positions, weight, live
    flag, cells: 45 bytes each) and the secondaries (positions, weight,
    cell id) read once, the column table and edges read once, both
    histograms written once."""
    return int(n1) * 45 + int(n2) * (32 + int(key_bytes)) + 4 * int(ncols) \
        + 8 * int(nedges) + 16 * hist_bins(nedges, nb2)
