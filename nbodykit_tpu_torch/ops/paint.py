"""Local paint (scatter-add) and readout (gather) (counterpart of
``nbodykit_tpu/ops/paint.py``).

Positions arrive in *cell units*. Indices wrap periodically modulo
``period`` (the global mesh size per axis) and are then offset into the
local block (rows ``[origin, origin + n0l)`` of the period).

Two paint kernels:

- :func:`paint_local`: ``index_add_`` of the s^3 window terms, chunked
  over particles.
- :func:`paint_local_mxu`: particles bucketed by the (x-row-tile,
  y-col-tile) of their base cell, each bucket padded to a capacity
  ``Kcap``, every bucket deposited into a dense (M, N2) tile block
  (``ops/paint_cuda.py``: a CUDA kernel on the card, the one-hot
  product on the CPU), and the tiles folded home with dense shifted
  adds. The bucket keys, ``Kcap`` / ``npieces`` / ``ck`` sizing, stripe
  fold and x-unpad are those of the JAX function.
"""

import torch
import torch.nn.functional as F

from .paint_cuda import deposit_blocks
from .radix import order_keys
from .window import (window_base, window_support, window_weights,
                     window_weights_grad)

# cap on the one-hot Z expansion of one piece (bytes); it sizes the
# mxu paint's pieces exactly as in the JAX package
ZCHUNK_BYTES = 1 << 28
# tile blocks per group of the fold (bytes): its temporaries are a few
# times this, beside the mesh
FOLD_CHUNK_BYTES = 1 << 30


def _out_dtype(pos, mass, out):
    if out is not None:
        return out.dtype
    return mass.dtype if isinstance(mass, torch.Tensor) else pos.dtype


def _axis_terms(pos_ax, resampler, period, grad=False):
    """Per-axis neighbour indices (int64, wrapped mod period) and
    weights, shapes (n, s); ``grad=True`` gives the derivative weights
    dW/dx (cell units) instead."""
    weights = window_weights_grad if grad else window_weights
    idx, w = weights(pos_ax, resampler)
    return torch.remainder(idx, period).long(), w


def _offset_terms(pos, mass, resampler, period, origin, n0l,
                  grad_axis=None):
    """Yield (lin_index int64, weight) per window offset (i, j, k) in
    s^3, all 1-D over particles; rows outside the block get weight 0.
    ``grad_axis`` (0/1/2) swaps that axis's window for its derivative
    dW/dx, so a gather with these weights is d(readout)/d(pos[axis]) in
    cell units."""
    s = window_support(resampler)
    N1, N2 = period[1], period[2]
    i0, w0 = _axis_terms(pos[:, 0], resampler, period[0],
                         grad=grad_axis == 0)
    i1, w1 = _axis_terms(pos[:, 1], resampler, period[1],
                         grad=grad_axis == 1)
    i2, w2 = _axis_terms(pos[:, 2], resampler, period[2],
                         grad=grad_axis == 2)
    for a in range(s):
        row = torch.remainder(i0[:, a] - origin, period[0])
        valid = row < n0l
        row_c = torch.where(valid, row, 0)
        for b in range(s):
            for c in range(s):
                w = w0[:, a] * w1[:, b] * w2[:, c]
                if mass is not None:
                    w = w * mass
                w = torch.where(valid, w, 0.0)
                lin = (row_c * N1 + i1[:, b]) * N2 + i2[:, c]
                yield lin, w


def paint_local(pos, mass, shape, resampler='cic', period=None, origin=0,
                out=None, chunk=None):
    """Scatter particles onto a local mesh block with ``index_add_``.

    pos : (n, 3) positions in global cell units; mass : (n,) or scalar
    (0 masks a slot); shape : (n0l, N1, N2) local block; period : global
    mesh size (defaults to ``shape``); origin : global row of the
    block's first row; out : block to accumulate onto; chunk :
    particles per pass (default all). Returns the (n0l, N1, N2) block.
    """
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in (shape if period is None else period))
    n = pos.shape[0]
    dtype = _out_dtype(pos, mass, out)
    flat = torch.zeros(n0l * N1 * N2, dtype=dtype, device=pos.device) \
        if out is None else out.reshape(-1).to(dtype).clone()
    mass = torch.as_tensor(mass, dtype=dtype,
                           device=pos.device).expand(n)
    step = n if not chunk or chunk >= n else int(chunk)
    for lo in range(0, n, max(step, 1)):
        for lin, w in _offset_terms(pos[lo:lo + step], mass[lo:lo + step],
                                    resampler, period, origin, n0l):
            flat.index_add_(0, lin, w.to(dtype))
    return flat.reshape(n0l, N1, N2)


def readout_local(block, pos, resampler='cic', period=None, origin=0,
                  grad_axis=None):
    """Interpolate a local mesh block at particle positions (gather);
    rows outside the block contribute 0. Returns (n,) values; with
    ``grad_axis``, their derivative along that axis in cell units."""
    n0l = int(block.shape[0])
    period = tuple(int(p) for p in (block.shape if period is None
                                    else period))
    flat = block.reshape(-1)
    vals = torch.zeros(pos.shape[0], dtype=block.dtype, device=pos.device)
    for lin, w in _offset_terms(pos, None, resampler, period, origin, n0l,
                                grad_axis=grad_axis):
        vals = vals + flat[lin] * w.to(block.dtype)
    return vals


def _bucket_by_argsort(key, n, B, Kcap, order_method='auto'):
    """Assign each particle a slot in a (B, Kcap) padded bucket layout.

    Returns ``src`` (B*Kcap,) int64, the source particle per slot (n for
    empty slots), and ``overflow``, a 0-d tensor counting particles
    whose bucket exceeded Kcap (their deposits are dropped; the caller
    retries with a larger slack). Key B is the trash bucket."""
    dev = key.device
    order = order_keys(key, B + 1, order_method)
    skey = key[order].long()
    iot = torch.arange(n, dtype=torch.int64, device=dev)
    # rank within the bucket: the keys are sorted, so bucket k's run
    # starts at the count of smaller keys
    counts = torch.bincount(skey, minlength=B + 1)
    rank = iot - (torch.cumsum(counts, 0) - counts)[skey]
    over = (rank >= Kcap) & (skey < B)
    slot = torch.where((rank >= Kcap) | (skey >= B), B * Kcap,
                       skey * Kcap + rank)
    # slot B*Kcap collects the dropped entries and is cut off
    src = torch.full((B * Kcap + 1,), n, dtype=torch.int64, device=dev)
    src[slot] = order
    return src[:B * Kcap], over.sum()


def mxu_plan(n, shape, resampler, period, itemsize, rb=8, cb=8,
             slack=2.0, zchunk_bytes=ZCHUNK_BYTES):
    """The mxu paint's tile geometry and bucket sizing for n particles on
    a (n0l, N1, N2) block, or None where the JAX package takes its
    scatter fallback (window wider than the block). Identical to the
    JAX sizing, including the one retry with smaller tiles."""
    n0l, N1, N2 = (int(x) for x in shape)
    p0 = int(period[0])
    s = window_support(resampler)
    rb, cb = max(rb, s), max(cb, s)
    rb, cb = min(rb, n0l), min(cb, N1)
    if n0l < max(s, 2) or N1 < s or N2 < s or n0l < rb:
        return None
    ntx = -(-n0l // rb)
    nty = -(-N1 // cb)
    if ntx * rb - n0l + s - 1 > n0l or nty * cb - N1 + s - 1 > N1:
        rb2, cb2 = min(rb, max(s, n0l // 2)), min(cb, max(s, N1 // 2))
        if (rb, cb) != (rb2, cb2):
            return mxu_plan(n, shape, resampler, period, itemsize, rb=rb2,
                            cb=cb2, slack=slack, zchunk_bytes=zchunk_bytes)
        return None
    frac = min(rb, n0l) / float(n0l * nty)
    Kcap = max(8, int(n * frac * slack) + 1)
    Kcap = -(-Kcap // 8) * 8
    zrow = max(nty * N2 * itemsize, 1)
    npieces = max(1, -(-Kcap * zrow // max(int(zchunk_bytes), zrow * 8)))
    ck = max(8, -(-Kcap // npieces))
    ck = -(-ck // 8) * 8
    return dict(s=s, rb=rb, cb=cb, n0l=n0l, p0=p0, N1=N1, N2=N2,
                ntx=ntx, nty=nty, B=(ntx + 1) * nty, Kcap=npieces * ck,
                npieces=npieces, ck=ck)


def mxu_payload(pos, mass, plan, resampler, origin, order_method='auto'):
    """Bucket the particles and gather the padded payload.

    Returns ``(sx, sy, sz, sm, overflow)``: contiguous (ntx+1, nty,
    Kcap) positions (pos dtype) and masses (mass dtype, 0 on empty and
    dropped slots)."""
    n = pos.shape[0]
    rb, cb, n0l, p0 = plan['rb'], plan['cb'], plan['n0l'], plan['p0']
    ntx, nty, B, Kcap = plan['ntx'], plan['nty'], plan['B'], plan['Kcap']
    i0b = window_base(pos[:, 0], resampler)
    i1b = window_base(pos[:, 1], resampler)
    row0 = torch.remainder(i0b - origin, p0)
    # slab blocks: rows in [n0l, p0) sit "below" the block; shifted
    # negative so their wrapped-to-valid offsets land in the leading tile
    row0s = torch.where(row0 >= n0l, row0 - p0, row0)
    # zero-mass and fully-invalid particles go to the trash bucket
    keep = (row0s >= -rb) & (mass != 0)
    txf = torch.clamp(torch.div(row0s + rb, rb, rounding_mode='floor'),
                      0, ntx)
    ty = torch.div(torch.remainder(i1b, plan['N1']), cb,
                   rounding_mode='floor')
    key = torch.where(keep, txf * nty + ty, B)
    src, overflow = _bucket_by_argsort(key, n, B, Kcap, order_method)
    vsrc = src < n
    srcc = torch.clamp(src, max=max(n - 1, 0))
    ppos = pos[srcc]
    pmass = torch.where(vsrc & keep[srcc], mass[srcc],
                        torch.zeros((), dtype=mass.dtype, device=mass.device))
    shp = (ntx + 1, nty, Kcap)
    return (ppos[:, 0].reshape(shp).contiguous(),
            ppos[:, 1].reshape(shp).contiguous(),
            ppos[:, 2].reshape(shp).contiguous(),
            pmass.reshape(shp).contiguous(), overflow)


def mxu_fold(blocks, plan, full):
    """Fold the (ntx+1, nty, M, N2) tile blocks into the (n0l, N1, N2)
    block: y tiles into stripes (interior columns by reshape, halo
    columns by a cb-shifted add, the periodic y images wrapped), the
    stripes into the x-padded mesh, then the x unpad (periodic images
    folded in place when the block is the full mesh, dropped for slab
    blocks). Stripes are folded in groups of about FOLD_CHUNK_BYTES of
    blocks, so the temporaries stay small beside the mesh. Every cell
    sums the same operands in the same order as the JAX stripe scan
    (a padded-mesh cell takes at most two stripe terms onto zero, so the
    group order does not change it)."""
    s, rb, cb = plan['s'], plan['rb'], plan['cb']
    n0l, N1, N2, nty = plan['n0l'], plan['N1'], plan['N2'], plan['nty']
    T = plan['ntx'] + 1
    rbh, cbh = rb + s - 1, cb + s - 1
    P1 = nty * cb + s - 1
    blocks = blocks.reshape(T, nty, rbh, cbh, N2)
    stripe_bytes = blocks[0].numel() * blocks.element_size()
    group = max(1, FOLD_CHUNK_BYTES // max(1, stripe_bytes))
    # stripe t covers padded rows [t*rb, t*rb + rbh): its first rb rows
    # are its own, the last s-1 overlap the next stripe's first rows
    mesh_pad = torch.zeros(((T + 1) * rb, N1, N2), dtype=blocks.dtype,
                           device=blocks.device)
    for t0 in range(0, T, group):
        b = blocks[t0:t0 + group].permute(0, 2, 1, 3, 4)
        g = b.shape[0]
        interior = b[:, :, :, :cb].reshape(g, rbh, nty * cb, N2)
        halo = F.pad(b[:, :, :, cb:], (0, 0, 0, cb - (s - 1)))
        halo = halo.reshape(g, rbh, nty * cb, N2)
        slab = F.pad(interior, (0, 0, 0, s - 1))
        del interior
        slab = slab + F.pad(halo, (0, 0, cb, 0))[:, :, :P1]
        del halo
        slab = slab[:, :, :N1] + F.pad(slab[:, :, N1:],
                                       (0, 0, 0, 2 * N1 - P1))
        mesh_pad[t0 * rb:(t0 + g) * rb].view(g, rb, N1, N2).add_(
            slab[:, :rb])
        mesh_pad[(t0 + 1) * rb:(t0 + g + 1) * rb].view(
            g, rb, N1, N2)[:, :s - 1].add_(slab[:, rb:])
        del slab
    mesh_pad = mesh_pad[:T * rb + s - 1]
    block = mesh_pad[rb:rb + n0l]
    if full:
        # true rows [-rb, 0) wrap to the end, rows >= n0l to the start
        block[n0l - rb:].add_(mesh_pad[:rb])
        tail = mesh_pad[rb + n0l:]
        block[:tail.shape[0]].add_(tail)
    return block


def paint_local_mxu(pos, mass, shape, resampler='cic', period=None,
                    origin=0, out=None, rb=8, cb=8, slack=2.0,
                    return_overflow=False, zchunk_bytes=ZCHUNK_BYTES,
                    order_method='auto'):
    """Scatter particles onto a local mesh block through tile buckets.

    Semantics (global cell units, ``origin`` / ``period``, out-of-block
    rows masked) match :func:`paint_local`. ``slack`` sizes the bucket
    capacity; overflowing particles are DROPPED and counted (returned
    with ``return_overflow=True``). ``order_method`` is the bucketing's
    stable ordering engine (``ops.radix.order_keys``). The deposit runs
    on the CUDA kernel for CUDA tensors and on the one-hot product for
    CPU tensors."""
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in (shape if period is None else period))
    if (period[1], period[2]) != (N1, N2):
        raise ValueError("mxu paint requires full y/z axes "
                         "(period[1:] == shape[1:]); x is the sliced "
                         "axis in this framework")
    n = pos.shape[0]
    dtype = _out_dtype(pos, mass, out)
    plan = mxu_plan(n, shape, resampler, period,
                    torch.empty((), dtype=dtype).element_size(), rb=rb,
                    cb=cb, slack=slack, zchunk_bytes=zchunk_bytes)
    zero = torch.zeros((), dtype=torch.int64, device=pos.device)
    if plan is None or n == 0:
        # window wider than the block (test-sized meshes only): the
        # scatter kernel, as in the JAX package
        r = paint_local(pos, mass, shape, resampler=resampler,
                        period=period, origin=origin, out=out)
        return (r, zero) if return_overflow else r
    mass = torch.as_tensor(mass, dtype=dtype, device=pos.device).expand(n)
    sx, sy, sz, sm, overflow = mxu_payload(pos, mass, plan, resampler,
                                           origin, order_method)
    blocks = deposit_blocks(sx, sy, sz, sm, resampler=resampler,
                            rb=plan['rb'], cb=plan['cb'], n0l=n0l,
                            p0=plan['p0'], N1=N1, N2=N2, origin=origin,
                            ck=plan['ck'])
    del sx, sy, sz, sm
    block = mxu_fold(blocks, plan, full=(n0l == plan['p0']))
    if out is not None:
        block = out + block
    if return_overflow:
        return block, overflow
    return block
