"""The neighbour moments of the three-point function: the Hopper kernel
and its plain version.

Computes the fold body of the JAX package's 3PCF
(``nbodykit_tpu/algorithms/threeptcf.py:58-72``, ``_se_chunk_zeta``
under ``GridHash.fold``; XLA, no Pallas kernel): for every live query
``i``,

    a[i, lm, b] = sum_j w_s[j] Y_lm(d / |d|) [digitize(r2, r2edges) - 1 == b]

over the candidates ``j`` of its neighbour cells with ``r2 > 1e-20``,
``d = pos_s[j] - p[i]`` (minimum-imaged when periodic), the real Y_lm of
:func:`..algorithms.convpower.fkp.get_real_Ylm` for ell in ``ells``
(sorted) and m = -ell..ell, in that order: an (m, nlm, nbins) f64 array.

:func:`threept_alm_plain` is that body in torch on
:meth:`.devicehash.DeviceGridHash.fold` (blocks of slots, an einsum a
block); :func:`threept_alm_cuda` launches ``csrc/threept_alm.cu`` (a CTA
an item of queries of one cell, a warp a query, its in-bin pairs queued
and taken 32 at a time, a lane evaluating all the Y_lm of one pair, the
moments in the lanes' registers, added on the FP64 tensor cores).
:func:`threept_alm` dispatches on the queries' device.
"""

import ctypes
from math import factorial, pi, sqrt

import numpy as np
import torch

# threads a CTA of the kernel (csrc/threept_alm.cu TA_THREADS, TA_WARPS),
# queries an item (TA_ITEM), the bins a lane's register moments take
# (TA_NB) and the largest ell of the register path (TA_LMAX), a warp's
# queue of in-bin pairs and the pairs a batch takes (QCAP, QBATCH)
TA_THREADS = 128
TA_WARPS = TA_THREADS // 32
TA_ITEM = 16
TA_NB = 16
TA_LMAX = 4
QCAP, QBATCH = 64, 32
SMEM_LIMIT = 232448
PLAIN_BLOCK = 32


def lm_table(ells):
    """(l, m, norm, W_mm) of every real Y_lm of the sorted ``ells``, m
    from -ell to ell: the constants of ``get_real_Ylm``."""
    ls, ms, norms, wmms = [], [], [], []
    for ell in sorted(ells):
        for m in range(-ell, ell + 1):
            ma = abs(m)
            norm = sqrt((2 * ell + 1) / (4 * pi)
                        * factorial(ell - ma) / factorial(ell + ma))
            if m != 0:
                norm *= sqrt(2.0)
            wmm = 1.0
            for i in range(ma):
                wmm = -wmm * (2 * i + 1)
            ls.append(ell)
            ms.append(m)
            norms.append(norm)
            wmms.append(wmm)
    return ls, ms, norms, wmms


def moments_in_registers(nbins, lmax):
    """Whether the kernel keeps the moments in the lanes' registers (at
    most TA_NB bins, and ell at most TA_LMAX: 25 harmonics over 32
    lanes), else in shared memory."""
    return int(nbins) <= TA_NB and int(lmax) <= TA_LMAX


def smem_bytes(nbins, nlm, lmax, tab_len):
    """Shared memory of one CTA of the kernel: the device bin table (16
    bytes an entry), the edges, the norms, W_mm, 1 / k and each l's first
    index and the runs (rounded to 16 bytes), then every warp's queue (36
    bytes a pair), a batch's harmonics and, for moments not in
    registers, the nlm x nbins f64 moments."""
    head = 16 * int(tab_len) + 8 * (int(nbins) + 1) + 8 * int(nlm) \
        + 24 * (int(lmax) + 1) + 3 * 18 * 4
    warp = QCAP * 36 + QBATCH * int(nlm) * 8
    if not moments_in_registers(nbins, lmax):
        warp += int(nlm) * int(nbins) * 8
    return -(-head // 16) * 16 + TA_WARPS * warp


def threept_alm_plain(grid, w_s, p, live, ci, r2edges, ells,
                      block=PLAIN_BLOCK):
    """The moments in torch, on any device.

    grid : a :class:`.devicehash.DeviceGridHash` of f64 positions; w_s :
    (n,) f64 weights in its sorted order; p : (m, 3) f64 queries; live :
    (m,) bool; ci : (m, 3) int32 query cells; r2edges : (nbins + 1,)
    squared edges; ells : the multipoles. Returns (m, nlm, nbins) f64.
    """
    from ..algorithms.convpower.fkp import get_real_Ylm
    dev = p.device
    e = torch.as_tensor(r2edges, dtype=torch.float64, device=dev)
    nbins = e.numel() - 1
    ylms = [get_real_Ylm(ell, m) for ell in sorted(ells)
            for m in range(-ell, ell + 1)]
    alm = torch.zeros((p.shape[0], len(ylms), nbins), dtype=torch.float64,
                      device=dev)

    def body(alm, j, valid, d, r2):
        ok = valid & live[:, None] & (r2 > 1e-20)
        rr = torch.sqrt(torch.where(r2 == 0, 1.0, r2))
        u = d / rr[..., None]
        dig = torch.bucketize(r2, e, right=True) - 1
        inb = ok & (dig >= 0) & (dig < nbins)
        digc = torch.clamp(dig, 0, nbins - 1)
        wj = torch.where(inb, w_s[j], 0.0)
        yv = torch.stack([Y(u[..., 0], u[..., 1], u[..., 2]) for Y in ylms],
                         dim=-1)
        onehot = torch.nn.functional.one_hot(digc, nbins).to(torch.float64) \
            * wj[..., None]
        return alm + torch.einsum('qsl,qsb->qlb', yv, onehot)

    return grid.fold(p, ci, body, alm, block=block)


# pos, w, flat, cols; n2, key bytes; p, live, ci; m; r2edges; nbins; l,
# m, norm, W_mm; nlm, lmax, periodic; dlo, dhi, ncell, box; out; items,
# max items; bin table, its length, shift, base and steps; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_void_p]
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_void_p])

_fns = {}


def _fn():
    if 'alm' not in _fns:
        from .._build import load
        fn = load('threept_alm').nbk_threept_alm
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns['alm'] = fn
    return _fns['alm']


_LM = {}


def device_lm_table(ells, device):
    """:func:`lm_table` on ``device`` (int32 l and m, f64 norms and W_mm),
    kept for the poles and device last asked for (a 3PCF's chunks share
    them)."""
    key = (str(device), tuple(sorted(ells)))
    if key not in _LM:
        ls, ms, norms, wmms = lm_table(ells)
        _LM.clear()
        _LM[key] = (torch.tensor(ls, dtype=torch.int32, device=device),
                    torch.tensor(ms, dtype=torch.int32, device=device),
                    torch.tensor(norms, dtype=torch.float64, device=device),
                    torch.tensor(wmms, dtype=torch.float64, device=device))
    return _LM[key]


def launch_args(grid, w_s, p, live, ci, r2edges, ells, out):
    """The arguments of ``nbk_threept_alm`` (:data:`ARGTYPES`) for checked
    tensors and an (m, nlm, nbins) f64 output, and the tensors made here
    (the edges on the device, the lm table, the items, the bin table),
    which the caller keeps alive until the launch has run: (args,
    keep)."""
    from .fof_cuda import axis_offsets
    from .paircount_cuda import edges_and_table, query_items
    dev = p.device
    ls = lm_table(ells)[0]
    lm_l, lm_m, lm_norm, lm_wmm = device_lm_table(ells, dev)
    items, max_items = query_items(grid._flatten(ci), TA_ITEM)
    e, tab, shift, base, steps = edges_and_table(r2edges, dev)
    dlo, dhi = axis_offsets(grid.offsets)
    ints = ctypes.c_int * 3
    args = (
        grid.pos_s.data_ptr(), w_s.data_ptr(), grid.flat_s.data_ptr(),
        grid.columns().data_ptr(), grid.pos_s.shape[0],
        grid.flat_s.element_size(), p.data_ptr(), live.data_ptr(),
        ci.data_ptr(), p.shape[0], e.data_ptr(), e.numel() - 1,
        lm_l.data_ptr(), lm_m.data_ptr(), lm_norm.data_ptr(),
        lm_wmm.data_ptr(), len(ls), max(ls), int(bool(grid.periodic)),
        ints(*dlo), ints(*dhi), ints(*[int(v) for v in grid.ncell_np]),
        (ctypes.c_double * 3)(*[float(v) for v in grid.box_np]),
        out.data_ptr(), items.data_ptr(), max_items, tab.data_ptr(),
        tab.shape[0], shift, base, steps,
        torch.cuda.current_stream(dev).cuda_stream)
    return args, (e, lm_l, lm_m, lm_norm, lm_wmm, items, tab)


def threept_alm_cuda(grid, w_s, p, live, ci, r2edges, ells):
    """The moments on the CUDA kernel (``threept_alm_kernel``): the
    contract of :func:`threept_alm_plain`, equal to it up to the order of
    the f64 sums. All tensors contiguous on one CUDA device; queries in
    the grid's cell order fill the kernel's items."""
    from .._build import check
    from .fof_cuda import _check_cuda
    from .paircount_cuda import PC_TAB_MAX
    cols = grid.columns()
    m = p.shape[0]
    n2 = grid.pos_s.shape[0]
    _check_cuda('threept_alm_cuda', (grid.pos_s, w_s, grid.flat_s, cols, p,
                                     live, ci))
    if grid.pos_s.dtype != torch.float64 or w_s.dtype != torch.float64 \
            or p.dtype != torch.float64 or live.dtype != torch.bool \
            or ci.dtype != torch.int32:
        raise ValueError("dtypes: positions and weights f64, live bool, "
                         "cells int32")
    if p.shape != (m, 3) or live.shape != (m,) or ci.shape != (m, 3) \
            or w_s.shape != (n2,):
        raise ValueError("shapes: p %s, live %s, ci %s, w %s"
                         % (tuple(p.shape), tuple(live.shape),
                            tuple(ci.shape), tuple(w_s.shape)))
    if m >= 2 ** 31 or n2 >= 2 ** 31:
        raise ValueError("threept_alm_cuda takes n < 2**31")
    nbins = len(r2edges) - 1
    ls = lm_table(ells)[0]
    nlm = len(ls)
    lmax = max(ls)
    if nbins < 1 or smem_bytes(nbins, nlm, lmax, PC_TAB_MAX + 1) \
            > SMEM_LIMIT:
        raise ValueError("%d bins x %d harmonics do not fit a CTA's shared "
                         "memory" % (nbins, nlm))
    out = torch.empty((m, nlm, nbins), dtype=torch.float64, device=p.device)
    if m == 0:
        return out
    args, keep = launch_args(grid, w_s, p, live, ci, r2edges, ells, out)
    check('threept_alm', _fn()(*args))
    threept_alm_cuda.launches += 1
    return out


threept_alm_cuda.launches = 0


def threept_alm(grid, w_s, p, live, ci, r2edges, ells):
    """The moments on the queries' device: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor."""
    if p.device.type == 'cpu':
        return threept_alm_plain(grid, w_s, p, live, ci, r2edges, ells)
    if p.device.type != 'cuda':
        raise ValueError("no 3PCF moments for device %s" % p.device)
    return threept_alm_cuda(grid, w_s, p, live, ci, r2edges, ells)


def ylm_ops(ells):
    """f64 operations of one in-bin pair outside a matrix product, the
    least it needs: the unit vector (a sqrt, one division and 3
    products); for each |m| up to the largest ell a power of x + iy (6
    past the first) and the recurrence in l (2, then 5 a step); for every
    requested Y_lm its 2 products (norm, azimuthal factor). The weight's
    product and the sum into the moments are :func:`ylm_mma_ops`."""
    ls, ms = lm_table(ells)[:2]
    lmax = max(ls)
    ops = 5
    for m in range(lmax + 1):
        ops += 6 if m >= 2 else 0
        ops += sum(2 if ell == m + 1 else 5 for ell in range(m + 1, lmax + 1))
    return ops + 2 * len(ls)


def ylm_mma_ops(ells):
    """f64 operations of one in-bin pair that a matrix product on the
    FP64 tensor cores can do: each Y_lm times the weight and summed into
    its moment, one fused multiply-add (2) a Y_lm (moments += Y^T (w
    one-hot of the bin), the kernel's drain with the weight folded in)."""
    return 2 * len(lm_table(ells)[0])


def alm_bytes(m, n2, key_bytes, ncols, nbins, nlm):
    """Bytes the kernel must move: the queries (positions, live flag,
    cells: 37 bytes each) and the grid's points (positions, weight, cell
    id) read once, the column table read once, the moments written
    once."""
    return int(m) * (37 + 8 * int(nlm) * int(nbins)) \
        + int(n2) * (32 + int(key_bytes)) + 4 * int(ncols) \
        + 8 * (int(nbins) + 1)
