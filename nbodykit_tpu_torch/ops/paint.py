"""Local paint (scatter-add) and readout (gather) (counterpart of
``nbodykit_tpu/ops/paint.py``).

Positions arrive in *cell units*. Indices wrap periodically modulo
``period`` (the global mesh size per axis) and are then offset into the
local block (rows ``[origin, origin + n0l)`` of the period).

The paint families (``paint_method``):

- :func:`paint_local` ('scatter'): ``index_add_`` of the s^3 window
  terms, chunked over particles.
- :func:`paint_local_sorted` ('sort') and :func:`paint_local_segsum`
  ('segsum'): one stable sort of the n base cells, the runs of equal
  cells summed (doubling shift-adds, or one segment sum), one scatter
  of unique indices per window offset; the segsum paint orders with the
  radix sort on the card (``ops/radix.py``, the rank pass kernel).
- :func:`paint_local_streams` ('streams'): the s^3 offset streams dealt
  onto k replica meshes, optionally stored bfloat16.
- :func:`paint_local_mxu` ('mxu'): particles bucketed by the (x-row-tile,
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
from ..utils import is_narrow_float, stage, torch_dtype
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


_INT32_MAX = 2 ** 31 - 1


def _one_sort_streams(pos, mass, shape, resampler, period, origin,
                      dtype, order_method='argsort'):
    """Shared preamble of :func:`paint_local_sorted` and
    :func:`paint_local_segsum`: ONE stable ordering of the n base cells.
    For every window offset (a, b, c) the un-wrapped deposit key is the
    base key plus d = (a*N1 + b)*N2 + c, so base order keeps equal
    deposit keys contiguous for every offset at once and the runs are
    shared.

    Returns ``(keys, is_start, is_last, offs, W, fbk, fbv, sent)``: the
    sorted base keys (int64), the run-start and run-end masks, the s^3
    key offsets, the (s^3, n) un-wrapped weight streams in sorted order,
    the deposits that wrap the periodic boundary (keys, values; the
    plain scatter adds them), and ``sent``, the first index past every
    ``key + d``. The JAX function keeps the wrapped deposits as an
    s^3*n stream whose masked slots it drops at out-of-bounds indices;
    torch has no dropping scatter, so the stream is compacted to the
    wrapped deposits, and no index past ``sent`` is formed (nor JAX's
    int32 case for one).

    order_method : the stable ordering engine of the rank
        (:func:`~nbodykit_tpu_torch.ops.radix.order_keys` over the
        [0, M) cell alphabet); both engines give the same order.

    Stages (``utils.stage``): ``paint_order`` (the base keys and their
    rank), ``paint_streams`` (the sorted streams).
    """
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in period)
    M = n0l * N1 * N2
    s = window_support(resampler)
    sent = M + (s - 1) * (N1 * N2 + N2 + 1) + 1
    # the JAX function's flat keys are int32: it raises here, before
    # anything is allocated, and so does the port
    if sent > _INT32_MAX:
        raise ValueError(
            "one-sort paint: local block %dx%dx%d (+window %d) "
            "overflows the int32 flat index; shard the mesh over more "
            "devices so n0_local*N1*N2 < 2**31" % (n0l, N1, N2, s))
    n = pos.shape[0]
    with stage('paint_order'):
        i0, w0 = _axis_terms(pos[:, 0], resampler, period[0])
        i1, w1 = _axis_terms(pos[:, 1], resampler, period[1])
        i2, w2 = _axis_terms(pos[:, 2], resampler, period[2])
        row0 = torch.remainder(i0[:, 0] - origin, period[0])
        valid0 = row0 < n0l
        # in [0, M): the row clamped, i1 / i2 wrapped
        lin_base = (torch.where(valid0, row0, 0) * N1 + i1[:, 0]) * N2 \
            + i2[:, 0]
        order = order_keys(lin_base, M, order_method)
    with stage('paint_streams'):
        # JAX's wrap tests compare each offset's wrapped index with the
        # base index plus the offset; the wrapped index is (base + a)
        # mod the period, so the test is base + a < period, and only
        # the base columns need the sorted order. Every gather is of one
        # column: on the card a gather of (n, s) rows took ~6 ms where a
        # column takes ~0.1
        i1s, i2s = i1[:, 0][order], i2[:, 0][order]
        del i0, i1, i2
        w0s, w1s, w2s = ([w[:, a][order].to(dtype) for a in range(s)]
                         for w in (w0, w1, w2))
        del w0, w1, w2
        ms = mass[order]
        keys = lin_base[order]
        row0s, valid0s = row0[order], valid0[order]
        del order, lin_base, row0, valid0

        ones = torch.ones(min(n, 1), dtype=torch.bool, device=pos.device)
        neq = keys[1:] != keys[:-1]
        is_last = torch.cat([neq, ones])
        is_start = torch.cat([ones, neq])

        # only a particle whose window reaches past the block's last row
        # or an axis's end (or whose base row is outside the block) has
        # deposits that wrap or drop; every other deposit is un-wrapped
        reach = s - 1
        e = torch.nonzero(~valid0s | (row0s + reach >= n0l)
                          | (i1s + reach >= N1)
                          | (i2s + reach >= N2)).squeeze(1)
        row0e, valid0e, i1e, i2e = row0s[e], valid0s[e], i1s[e], i2s[e]

        W = torch.empty((s ** 3, n), dtype=dtype, device=pos.device)
        zero = torch.zeros((), dtype=dtype, device=pos.device)
        offs, fbk, fbv = [], [], []
        for a in range(s):
            rowa = torch.remainder(row0e + a, period[0])
            valida = rowa < n0l
            in_row = valida & valid0e & (row0e + a < period[0])
            for b in range(s):
                wab = w0s[a] * w1s[b]
                in_ab = in_row & (i1e + b < N1)
                for c in range(s):
                    j = len(offs)
                    offs.append((a * N1 + b) * N2 + c)
                    torch.mul(wab * w2s[c], ms, out=W[j])
                    # JAX's where(unwrapped, w, 0) and its fallback
                    # stream of the wrapped in-block deposits (the
                    # periodic boundary strip), on the edge particles
                    unwrapped = in_ab & (i2e + c < N2)
                    we = W[j, e]
                    W[j, e] = torch.where(unwrapped, we, zero)
                    at = torch.nonzero(valida & ~unwrapped).squeeze(1)
                    fbk.append((rowa[at] * N1 + torch.remainder(
                        i1e[at] + b, N1)) * N2
                        + torch.remainder(i2e[at] + c, N2))
                    fbv.append(we[at])
        return (keys, is_start, is_last, offs, W, torch.cat(fbk),
                torch.cat(fbv), sent)


def paint_local_sorted(pos, mass, shape, resampler='cic', period=None,
                       origin=0, out=None, npasses=None):
    """Paint by sort + segmented reduction + unique scatter (the JAX
    ``paint_local_sorted``).

    The n base cells are sorted once (:func:`_one_sort_streams`, with
    ``torch.argsort``, as the JAX function hard-wires); each equal-key
    run is summed in place by doubling shift-add passes
    ``W + where(same, W[:, src], 0)`` until no run spans the shift
    (ceil(log2(longest run)) passes, one host sync each), and the run
    totals at the run ends go to ``key + d`` with one scatter of unique
    indices per offset. ``npasses`` caps the passes (None: to
    completion). Semantics match :func:`paint_local`. Stages
    (``utils.stage``): those of :func:`_one_sort_streams`, then
    ``paint_runs`` and ``paint_scatter``."""
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in (shape if period is None else period))
    n = pos.shape[0]
    M = n0l * N1 * N2
    dtype = _out_dtype(pos, mass, out)
    mass = torch.as_tensor(mass, dtype=dtype, device=pos.device).expand(n)
    keys, _, is_last, offs, W, fbk, fbv, sent = _one_sort_streams(
        pos, mass, shape, resampler, period, origin, dtype, 'argsort')

    # segmented inclusive prefix sums over all s^3 streams at once; the
    # last slot of each run ends with the run total
    with stage('paint_runs'):
        max_shift = n if npasses is None else min(n, 1 << npasses)
        idx = torch.arange(n, device=pos.device)
        shift, active = 1, n > 0
        while active and shift < max_shift:
            src = torch.clamp(idx - shift, min=0)
            same = (idx >= shift) & (keys == keys[src])
            W = W + torch.where(same, W[:, src], 0)
            src = torch.clamp(idx - 2 * shift, min=0)
            active = bool(((idx >= 2 * shift)
                           & (keys == keys[src])).any())
            shift *= 2
        del idx
        ends = torch.nonzero(is_last).squeeze(1)
        W = W[:, ends]
    with stage('paint_scatter'):
        return _scatter_runs(out, M, sent, fbk, fbv, keys[ends], offs, W,
                             shape)


def _scatter_runs(out, M, sent, fbk, fbv, run_keys, offs, totals, shape):
    """The one-sort paints' output: ``out`` (or zeros), the wrapped
    deposits, then the (s^3, runs) totals at ``run_keys + d``, unique
    indices per offset; a zero tail to ``sent`` takes the totals of
    wrapped runs (zero by construction) and is cut off."""
    flat = torch.zeros(sent, dtype=totals.dtype, device=totals.device)
    if out is not None:
        flat[:M] = out.reshape(-1)
    flat.index_add_(0, fbk, fbv)
    for j, d in enumerate(offs):
        flat.index_add_(0, run_keys + d, totals[j])
    return flat[:M].view(*shape)


def paint_local_segsum(pos, mass, shape, resampler='cic', period=None,
                       origin=0, out=None, order_method='argsort'):
    """One-sort paint with a segment-sum run reduction (the JAX
    ``paint_local_segsum``).

    The rank of :func:`paint_local_sorted` (``order_method``: 'argsort'
    or 'radix', :func:`~nbodykit_tpu_torch.ops.radix.order_keys`), then
    one ``index_add_`` of all s^3 streams into (s^3, runs) segment
    totals (in index order on the CPU, as ``jax.ops.segment_sum``; in
    atomic order on a CUDA device), and the totals at the run starts go
    to ``key + d`` with one scatter of unique indices per offset. Stages
    as :func:`paint_local_sorted`'s."""
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in (shape if period is None else period))
    n = pos.shape[0]
    M = n0l * N1 * N2
    dtype = _out_dtype(pos, mass, out)
    mass = torch.as_tensor(mass, dtype=dtype, device=pos.device).expand(n)
    keys, is_start, _, offs, W, fbk, fbv, sent = _one_sort_streams(
        pos, mass, shape, resampler, period, origin, dtype, order_method)

    with stage('paint_runs'):
        # 0-based run ids, non-decreasing along the sorted slots
        seg = torch.cumsum(is_start, 0) - 1
        starts = torch.nonzero(is_start).squeeze(1)
        totals = torch.zeros((W.shape[0], starts.shape[0]), dtype=dtype,
                             device=pos.device).index_add_(1, seg, W)
        del W, seg
    with stage('paint_scatter'):
        return _scatter_runs(out, M, sent, fbk, fbv, keys[starts], offs,
                             totals, shape)


def paint_local_streams(pos, mass, shape, resampler='cic', period=None,
                        origin=0, out=None, streams=4, chunk=None,
                        storage_dtype=None):
    """Offset-stream scatter (the JAX ``paint_local_streams``): the s^3
    window-offset streams dealt round-robin onto ``k = streams`` replica
    meshes (clamped to [1, s^3]), ``index_add_`` chains into each, then
    a pairwise tree sum. ``chunk`` : particles per pass, as in
    :func:`paint_local`.

    ``storage_dtype`` a narrow float (bfloat16): the replicas are stored
    at that width while each weight is computed f32 and split two-sum
    style, the representable ``hi`` onto replica j and the residual
    ``lo`` onto replica j + 1; the replicas are re-widened to f32
    before the tree sum. The result is f32 (the compute dtype); callers
    narrow once, at their exit. None keeps one width. Stages
    (``utils.stage``): ``paint_deposit``, ``paint_merge``."""
    n0l, N1, N2 = (int(x) for x in shape)
    period = tuple(int(p) for p in (shape if period is None else period))
    n = pos.shape[0]
    s = window_support(resampler)
    k = max(1, min(int(streams), s ** 3))
    dtype = _out_dtype(pos, mass, out)
    narrow = storage_dtype is not None and is_narrow_float(storage_dtype)
    # what the replicas store; the weights compute at least f32 wide
    rdtype = torch_dtype(storage_dtype) if narrow else dtype
    mdtype = torch.float32 if narrow else dtype
    mass = torch.as_tensor(mass, dtype=mdtype, device=pos.device).expand(n)
    with stage('paint_deposit'):
        flats = [torch.zeros(n0l * N1 * N2, dtype=rdtype,
                             device=pos.device) for _ in range(k)]
        step = n if not chunk or chunk >= n else int(chunk)
        for lo in range(0, n, max(step, 1)):
            for j, (lin, w) in enumerate(_offset_terms(
                    pos[lo:lo + step], mass[lo:lo + step], resampler,
                    period, origin, n0l)):
                if narrow:
                    w32 = w.to(torch.float32)
                    hi = w32.to(rdtype)
                    flats[j % k].index_add_(0, lin, hi)
                    flats[(j + 1) % k].index_add_(
                        0, lin, (w32 - hi.to(torch.float32)).to(rdtype))
                else:
                    flats[j % k].index_add_(0, lin, w.to(dtype))
    with stage('paint_merge'):
        if narrow:
            flats = [f.to(torch.float32) for f in flats]
        while len(flats) > 1:
            nxt = [a + b for a, b in zip(flats[::2], flats[1::2])]
            if len(flats) % 2:
                nxt.append(flats[-1])
            flats = nxt
        flat = flats[0]
        if out is not None:
            flat = flat + out.reshape(-1).to(flat.dtype)
    return flat.view(n0l, N1, N2)


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
