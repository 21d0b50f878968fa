"""The mxu paint's tile deposit: Hopper kernel and plain version.

Replaces the Pallas TPU kernel ``nbodykit_tpu/ops/paint_pallas.py``
``_deposit_kernel`` (and the XLA ``piece()`` of ``ops/paint.py``). For
every x-stripe t, y-tile bucket ty and padded slot p of the bucket
payload, it deposits the slot's s^3 window terms into the
(M, N2) tile block, M = (rb+s-1)(cb+s-1):

    blocks[t, ty, (rloc+a)*cbh + (yloc+b), (z0+c) mod N2]
        += (w0_a * w1_b) * mass * w2_c

Columns outside [0, M) and slots of mass 0 contribute nothing.

The TPU builds one-hot matrices (W0Y (K, M), Z (K, N2)) and multiplies
them because it has a matrix unit and no scatter; per bucket that
product holds only n*s^3 nonzero terms. ``csrc/paint_deposit.cu``
deposits those terms directly with shared-memory atomics into the
bucket's tile, held whole in one CTA where it fits (CIC and TSC f32 at
N2 = 512) and else split along z over a thread-block cluster whose CTAs
add into each other's tiles; persistent CTAs walk the buckets and write
each finished tile with asynchronous bulk copies while they load the
next bucket's slots into registers. :func:`deposit_plan` holds the
launch geometry. Atomics reorder the sums, so results differ from the plain
version in the last bits.

Bound on the H100: bytes. The payload is read once (masses of every
slot, positions of the occupied ones) and the blocks are written once;
the s^3 multiply-adds per slot are negligible next to that.

Plain version: :func:`deposit_blocks_plain`, the one-hot ``piece()``
and a batched product, used for CPU tensors and, on the card, only to
check the kernel.
"""

import ctypes

import torch

from .window import window_support, window_weights

# shared memory one CTA may use on Hopper (227 KB), and what the kernel
# keeps beside the tile in static shared memory
SMEM_PER_CTA = 232448
SMEM_STATIC = 128
# threads per CTA of csrc/paint_deposit.cu (DEP_THREADS must match)
DEPOSIT_THREADS = 512
# the largest cluster Hopper launches; above 8 CTAs it is non-portable
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8


def _piece(t, x, y, z, m, *, s, resampler, rb, cb, n0l, p0, N1, N2,
           origin, nty, ck):
    """One piece of one stripe as the JAX ``piece()``: the (nty, M, N2)
    product of the one-hot x*y*mass and z expansions."""
    rbh, cbh = rb + s - 1, cb + s - 1
    M = rbh * cbh
    dtype = m.dtype
    dev = m.device
    ii0, ww0 = window_weights(x, resampler)
    ii1, ww1 = window_weights(y, resampler)
    ii2, ww2 = window_weights(z, resampler)
    r0 = torch.remainder(ii0[:, 0] - origin, p0)
    r0 = torch.where(r0 >= n0l, r0 - p0, r0)
    rloc = torch.clamp(r0 + rb - t * rb, 0, rb - 1)
    ty_k = torch.arange(nty, dtype=torch.int32,
                        device=dev).repeat_interleave(ck)
    yloc = torch.remainder(ii1[:, 0], N1) - ty_k * cb
    col_i = torch.arange(M, dtype=torch.int32, device=dev)
    z_i = torch.arange(N2, dtype=torch.int32, device=dev)
    w0y = torch.zeros((x.shape[0], M), dtype=dtype, device=dev)
    zm = torch.zeros((x.shape[0], N2), dtype=dtype, device=dev)
    for a in range(s):
        for b in range(s):
            col = (rloc + a) * cbh + (yloc + b)
            w = (ww0[:, a] * ww1[:, b]).to(dtype) * m
            w0y = w0y + torch.where(col[:, None] == col_i, w[:, None], 0)
    for c in range(s):
        zc = torch.remainder(ii2[:, c], N2)
        zw = ww2[:, c].to(dtype)
        zm = zm + torch.where(zc[:, None] == z_i, zw[:, None], 0)
    return torch.bmm(w0y.reshape(nty, ck, M).transpose(1, 2),
                     zm.reshape(nty, ck, N2))


def deposit_blocks_plain(sx, sy, sz, sm, *, resampler, rb, cb, n0l, p0,
                         N1, N2, origin, ck):
    """Plain PyTorch deposit: (T, nty, M, N2) blocks of all stripes from
    the padded bucket payload.

    sx, sy, sz : (T, nty, K) positions (global cell units); stripe t has
        stripe index t. sm : (T, nty, K) masses in the mesh dtype (empty
        slots carry 0). ck : slots per piece of the one-hot product
        (K % ck == 0); it bounds the one-hot's size, not the result.
    """
    T, nty, K = sx.shape
    s = window_support(resampler)
    M = (rb + s - 1) * (cb + s - 1)
    out = torch.empty((T, nty, M, N2), dtype=sm.dtype, device=sm.device)
    kw = dict(s=s, resampler=resampler, rb=rb, cb=cb, n0l=n0l, p0=p0,
              N1=N1, N2=N2, origin=origin, nty=nty, ck=ck)
    for t in range(T):
        blocks = torch.zeros((nty, M, N2), dtype=sm.dtype,
                             device=sm.device)
        for j in range(K // ck):
            sl = slice(j * ck, (j + 1) * ck)
            blocks = blocks + _piece(
                t, sx[t, :, sl].reshape(-1), sy[t, :, sl].reshape(-1),
                sz[t, :, sl].reshape(-1), sm[t, :, sl].reshape(-1), **kw)
        out[t] = blocks
    return out


def _ceil_div(a, b):
    return -(-a // b)


def deposit_plan(M, N2, itemsize):
    """Launch geometry of the deposit kernel for (M, N2) tiles of
    ``itemsize``-byte cells.

    One CTA holds a bucket's whole tile where it fits a CTA's shared
    memory (``nz`` = 1, ``zc`` = N2); else a cluster of the fewest ``nz``
    CTAs splits z into ranges of ``zc`` cells, rounded up to whole
    16-byte units, one CTA each. Returns a dict: ``nz``, ``zc``,
    ``z_ranges`` (each CTA's [z0, z1)), ``smem_bytes`` (dynamic shared
    memory per CTA), ``portable`` (nz <= 8), ``ragged`` (rows are not
    16-byte aligned in the output, so parts of them leave by plain stores
    instead of bulk copies) and ``threads``. Raises ValueError if no
    cluster of MAX_CLUSTER CTAs holds the tile."""
    M, N2, itemsize = int(M), int(N2), int(itemsize)
    if M < 1 or N2 < 1 or itemsize not in (4, 8):
        raise ValueError("bad deposit tile M=%d N2=%d itemsize=%d"
                         % (M, N2, itemsize))
    align = 16 // itemsize
    budget = SMEM_PER_CTA - SMEM_STATIC
    for nz in range(1, MAX_CLUSTER + 1):
        zc = N2 if nz == 1 else _ceil_div(_ceil_div(N2, nz), align) * align
        if (nz - 1) * zc >= N2:
            continue                   # the last CTA would own no z cell
        smem = _ceil_div(M * zc * itemsize, 16) * 16
        if smem <= budget:
            break
    else:
        raise ValueError("a (%d, %d) tile of %d-byte cells does not fit a "
                         "cluster of %d CTAs" % (M, N2, itemsize,
                                                 MAX_CLUSTER))
    return dict(nz=nz, zc=zc, smem_bytes=smem,
                portable=nz <= PORTABLE_CLUSTER,
                ragged=(N2 * itemsize) % 16 != 0, threads=DEPOSIT_THREADS,
                z_ranges=[(r * zc, min((r + 1) * zc, N2))
                          for r in range(nz)])


_FLOATS = (torch.float32, torch.float64)


def deposit_blocks_cuda(sx, sy, sz, sm, *, resampler, rb, cb, n0l, p0,
                        N1, N2, origin):
    """The deposit on the CUDA kernel (``csrc/paint_deposit.cu``). Same
    contract as :func:`deposit_blocks_plain`; positions may be f32 or
    f64 independently of the f32/f64 mass (mesh) dtype."""
    for name, a in (('sx', sx), ('sy', sy), ('sz', sz), ('sm', sm)):
        if not isinstance(a, torch.Tensor) or a.device.type != 'cuda':
            raise ValueError("deposit_blocks_cuda takes CUDA tensors "
                             "(%s)" % name)
        if not a.is_contiguous() or a.dim() != 3 \
                or a.shape != sx.shape or a.device != sx.device:
            raise ValueError("%s must be a contiguous (T, nty, K) tensor "
                             "on the device of sx, got %s"
                             % (name, tuple(a.shape)))
    if sx.dtype not in _FLOATS or sy.dtype != sx.dtype \
            or sz.dtype != sx.dtype or sm.dtype not in _FLOATS:
        raise ValueError("positions must share one float dtype and the "
                         "mass be f32/f64, got %s %s %s %s"
                         % (sx.dtype, sy.dtype, sz.dtype, sm.dtype))
    T, nty, K = sx.shape
    s = window_support(resampler)
    M = (rb + s - 1) * (cb + s - 1)
    if not (1 <= rb and 1 <= cb and s <= N2 and 0 < n0l <= p0):
        raise ValueError("bad deposit geometry rb=%d cb=%d n0l=%d p0=%d "
                         "N2=%d" % (rb, cb, n0l, p0, N2))
    plan = deposit_plan(M, N2, sm.element_size())
    out = torch.empty((T, nty, M, N2), dtype=sm.dtype, device=sm.device)
    if out.numel() == 0:
        return out
    from .._build import check, load
    fn = load('paint_deposit').nbk_deposit
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(sm.device).cuda_stream
    check('paint_deposit', fn(
        sx.data_ptr(), sy.data_ptr(), sz.data_ptr(), sm.data_ptr(),
        out.data_ptr(), int(sx.dtype == torch.float64),
        int(sm.dtype == torch.float64), s, T, nty, K, rb, cb, n0l, p0, N1,
        N2, int(origin), plan['zc'], plan['nz'], plan['smem_bytes'],
        stream))
    deposit_blocks_cuda.launches += 1
    return out


deposit_blocks_cuda.launches = 0


def deposit_blocks(sx, sy, sz, sm, *, ck, **geometry):
    """The deposit dispatched on the tensors' device: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if sm.device.type == 'cpu':
        return deposit_blocks_plain(sx, sy, sz, sm, ck=ck, **geometry)
    if sm.device.type == 'cuda':
        return deposit_blocks_cuda(sx, sy, sz, sm, **geometry)
    raise ValueError("no deposit for device %s" % sm.device)
