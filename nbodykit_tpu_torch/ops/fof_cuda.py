"""One min-label sweep of the grid-hash FOF: Hopper kernel and plain
version.

Computes ``neighbor_min`` of ``nbodykit_tpu/ops/devicehash.py:190-194``,
which the JAX package folds over ``DeviceGridHash.fold`` (:148-168) as a
``lax.while_loop`` of gathers per neighbour offset (XLA; no Pallas
kernel). On the cell-sorted arrays of a :class:`~.devicehash.DeviceGridHash`:

    out[i] = min(labels[i], min{labels[j] : j in a neighbour cell of i,
                                r2(i, j) <= ll2})   for a valid query i

and ``labels[i]`` for an invalid one. ``csrc/fof_sweep.cu`` runs one
thread per sorted query with a binary search per neighbour offset; it
reads the sweep's input labels and writes a new array (a Jacobi sweep),
so it equals :func:`fof_sweep_plain` bit for bit.

The plain version is the JAX package's fold written in torch: per offset
the (start, count) tables by ``searchsorted``, then a loop over slots up
to that offset's largest referenced cell (one host sync per offset).
It writes ``r2`` as ``(dx*dx + dy*dy) + dz*dz``, the kernel's order.
"""

import ctypes

import numpy as np
import torch

# neighbour offsets the kernel takes; csrc/fof_sweep.cu MAX_OFFSETS must
# match
MAX_OFFSETS = 27


def _check_args(pos_s, ci_s, flat_s, valid_s, labels, offsets):
    n = labels.shape[0]
    if pos_s.shape != (n, 3) or ci_s.shape != (n, 3) \
            or flat_s.shape != (n,) or valid_s.shape != (n,):
        raise ValueError("shapes: pos %s, ci %s, flat %s, valid %s for %d "
                         "labels" % (tuple(pos_s.shape), tuple(ci_s.shape),
                                     tuple(flat_s.shape),
                                     tuple(valid_s.shape), n))
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError("1 to %d neighbour offsets, got %d"
                         % (MAX_OFFSETS, len(offsets)))


def fof_sweep_plain(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell,
                    box, ll2, periodic):
    """One Jacobi min-label sweep in torch, on any device.

    pos_s : (n, 3) f4/f8 sorted positions; ci_s : (n, 3) int32 cell
    coordinates; flat_s : (n,) int32/int64 sorted cell ids; valid_s :
    (n,) bool; labels : (n,) int32; offsets : neighbour offset triples;
    ncell : (3,) cells per axis; box : (3,) f8 box; ll2 : the squared
    linking length (cast to the positions' dtype, as is ``box``);
    periodic : minimum-image distances. Returns (n,) int32."""
    _check_args(pos_s, ci_s, flat_s, valid_s, labels, offsets)
    dev = labels.device
    best = labels.clone()
    if labels.shape[0] == 0:
        return best
    box_t = torch.as_tensor(np.asarray(box, 'f8'), dtype=pos_s.dtype,
                            device=dev)
    ll2_t = torch.tensor(float(ll2), dtype=pos_s.dtype, device=dev)
    ncell_t = torch.as_tensor(np.asarray(ncell), dtype=torch.int32,
                              device=dev)
    nc1, nc2 = int(ncell[1]), int(ncell[2])
    for off in offsets:
        nc = ci_s + torch.as_tensor(off, dtype=torch.int32, device=dev)
        if periodic:
            nc = torch.remainder(nc, ncell_t)
            oob = torch.zeros(nc.shape[0], dtype=torch.bool, device=dev)
        else:
            clipped = torch.minimum(torch.clamp(nc, min=0), ncell_t - 1)
            oob = (nc != clipped).any(dim=-1)
            nc = clipped
        nc = nc.to(flat_s.dtype)
        nflat = (nc[:, 0] * nc1 + nc[:, 1]) * nc2 + nc[:, 2]
        start = torch.searchsorted(flat_s, nflat)
        count = torch.searchsorted(flat_s, nflat, right=True) - start
        kmax = int(torch.where(oob, 0, count).max())
        for slot in range(kmax):
            ok = (slot < count) & ~oob
            j = torch.where(ok, start + slot, 0)
            d = pos_s[j] - pos_s
            if periodic:
                d = d - torch.round(d / box_t) * box_t
            r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            ok = ok & valid_s & (r2 <= ll2_t)
            best = torch.minimum(best, torch.where(ok, labels[j], best))
    return best


_fn = []


def _sweep_fn():
    if not _fn:
        from .._build import load
        fn = load('fof_sweep').nbk_fof_sweep
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def fof_sweep_cuda(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell,
                   box, ll2, periodic):
    """One sweep on the CUDA kernel (``csrc/fof_sweep.cu``): the
    contract of :func:`fof_sweep_plain`, bit-identical output. All
    tensors contiguous on one CUDA device, n < 2**31."""
    from .._build import check
    tensors = (pos_s, ci_s, flat_s, valid_s, labels)
    if not all(isinstance(t, torch.Tensor) and t.device.type == 'cuda'
               for t in tensors):
        raise ValueError("fof_sweep_cuda takes CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fof_sweep_cuda takes tensors on one device")
    _check_args(pos_s, ci_s, flat_s, valid_s, labels, offsets)
    if pos_s.dtype not in (torch.float32, torch.float64) \
            or ci_s.dtype != torch.int32 \
            or flat_s.dtype not in (torch.int32, torch.int64) \
            or valid_s.dtype != torch.bool or labels.dtype != torch.int32:
        raise ValueError("dtypes: pos f4/f8, ci int32, flat int32/int64, "
                         "valid bool, labels int32; got %s"
                         % [str(t.dtype) for t in tensors])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fof_sweep_cuda takes contiguous tensors")
    n = labels.shape[0]
    if n >= 2 ** 31:
        raise ValueError("the sweep kernel takes n < 2**31, got %d" % n)
    out = torch.empty_like(labels)
    if n == 0:
        return out
    offs = (ctypes.c_int * (3 * len(offsets)))(
        *[int(v) for off in offsets for v in off])
    nc = (ctypes.c_int * 3)(*[int(v) for v in ncell])
    bx = (ctypes.c_double * 3)(*[float(v) for v in box])
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    check('fof_sweep', _sweep_fn()(
        pos_s.data_ptr(), ci_s.data_ptr(), flat_s.data_ptr(),
        valid_s.data_ptr(), labels.data_ptr(), out.data_ptr(), n,
        pos_s.element_size(), flat_s.element_size(), offs, len(offsets),
        nc, bx, float(ll2), int(bool(periodic)), stream))
    fof_sweep_cuda.launches += 1
    return out


fof_sweep_cuda.launches = 0


def fof_sweep(pos_s, ci_s, flat_s, valid_s, labels, offsets, ncell, box,
              ll2, periodic):
    """One sweep dispatched on the labels' device: the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if labels.device.type == 'cpu':
        return fof_sweep_plain(pos_s, ci_s, flat_s, valid_s, labels,
                               offsets, ncell, box, ll2, periodic)
    if labels.device.type == 'cuda':
        return fof_sweep_cuda(pos_s, ci_s, flat_s, valid_s, labels,
                              offsets, ncell, box, ll2, periodic)
    raise ValueError("no FOF sweep for device %s" % labels.device)


def sweep_bytes(n, pos_itemsize, key_itemsize):
    """Bytes one sweep must move: the sorted positions, cell coordinates,
    cell ids, valid flags and labels read once, the labels written once."""
    return int(n) * (3 * pos_itemsize + 3 * 4 + key_itemsize + 1 + 4 + 4)
