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
:func:`paircount_hist_cuda` launches ``csrc/paircount.cu`` (one warp a
query over the column table, shared-memory histograms per CTA).
:func:`paircount_hist` dispatches on the queries' device.
"""

import ctypes

import numpy as np
import torch

# threads a CTA of the kernel (csrc/paircount.cu PC_THREADS)
PC_THREADS = 256
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


def smem_bytes(nedges, nb2):
    """Shared memory of one CTA of the kernel: 16 bytes a bin (count and
    sum) and 8 an edge."""
    return 16 * hist_bins(nedges, nb2) + 8 * int(nedges)


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
    pair with r2 == 0. Returns (npairs, wpairs), flat (nb1 + 2) * nb2
    f64 tensors. Queries go :data:`PLAIN_CHUNK` at a time, slots
    ``block`` at a time."""
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
# out_n, out_w; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_double] + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 4 + [ctypes.c_void_p] * 2
            + [ctypes.c_void_p])

_fns = {}


def _fn():
    if 'hist' not in _fns:
        from .._build import load
        fn = load('paircount').nbk_paircount_hist
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns['hist'] = fn
    return _fns['hist']


def launch_args(grid, w2_s, p1, w1, live1, ci1, e, mode, nb2, pimax, los,
                origin, is_auto, out_n, out_w):
    """The arguments of ``nbk_paircount_hist`` (:data:`ARGTYPES`) for
    checked tensors, the squared edges ``e`` on the device and int64 /
    f64 outputs of :func:`hist_bins` zeros; the caller keeps every tensor
    alive until the launch has run."""
    from .fof_cuda import axis_offsets
    dlo, dhi = axis_offsets(grid.offsets)
    ints = ctypes.c_int * 3
    dbls = ctypes.c_double * 3
    org = np.zeros(3) if origin is None else np.asarray(origin, 'f8')
    return (
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
        out_w.data_ptr(), torch.cuda.current_stream(p1.device).cuda_stream)


def paircount_hist_cuda(grid, w2_s, p1, w1, live1, ci1, r2edges, mode,
                        nb2=1, pimax=None, los=2, origin=None,
                        is_auto=False):
    """The histograms on the CUDA kernel (``paircount_kernel``): the
    contract of :func:`paircount_hist_plain`, ``npairs`` equal to it,
    ``wpairs`` up to the order of the f64 sums. All tensors contiguous
    on one CUDA device, n < 2**31 on both sides."""
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
    e = torch.as_tensor(r2edges, dtype=torch.float64,
                        device=p1.device).contiguous()
    if e.numel() < 2:
        raise ValueError("at least two edges")
    if smem_bytes(e.numel(), nb2) > SMEM_LIMIT:
        raise ValueError("%d bins do not fit a CTA's shared memory"
                         % hist_bins(e.numel(), nb2))
    nbins = hist_bins(e.numel(), nb2)
    out_n = torch.zeros(nbins, dtype=torch.int64, device=p1.device)
    out_w = torch.zeros(nbins, dtype=torch.float64, device=p1.device)
    if m == 0 or n2 == 0:
        return out_n.double(), out_w
    check('paircount', _fn()(*launch_args(
        grid, w2_s, p1, w1, live1, ci1, e, mode, nb2, pimax, los, origin,
        is_auto, out_n, out_w)))
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


def candidate_ops(mode, nedges, los, periodic):
    """f64 operations of one candidate in the kernel: the difference,
    the min-image tests (2 an axis when periodic), r2 (5), the mask,
    the binary search over the edges, the mode's dlos, mu or rp2 and
    bin (midpoint: 21 more), and the weight's product and sum."""
    ops = 3 + 5 + 1 + int(np.ceil(np.log2(int(nedges) + 1))) + 2
    if periodic:
        ops += 6
    if mode == '2d':
        ops += 1 + 3
    elif mode == 'projected':
        ops += 1 + 1 + 2 + int(np.ceil(np.log2(int(nedges) + 1)))
    if mode in ('2d', 'projected') and los == 'midpoint':
        ops += 21
    return ops


def hist_bytes(n1, n2, key_bytes, ncols, nedges, nb2):
    """Bytes the kernel must move: the queries (positions, weight, live
    flag, cells: 45 bytes each) and the secondaries (positions, weight,
    cell id) read once, the column table and edges read once, both
    histograms written once."""
    return int(n1) * 45 + int(n2) * (32 + int(key_bytes)) + 4 * int(ncols) \
        + 8 * int(nedges) + 16 * hist_bins(nedges, nb2)
