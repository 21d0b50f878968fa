"""Paint and readout of the PyTorch port against the JAX package: the
scatter paint and readout, the plain tile deposit against the Pallas
deposit kernel (interpret mode) on the same stripe payload, and the mxu
paint against JAX's ``deposit='pallas'`` and ``'xla'`` engines on a full
32^3 mesh and a weighted slab block.

Tolerance (f8): 1e-12 of the field's maximum. The port sums the deposit
terms in another order (``index_add_``, another matrix product), so the
last bits differ."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbodykit_tpu.ops import paint as jpaint
from nbodykit_tpu.ops.paint_pallas import deposit_blocks_pallas
from nbodykit_tpu_torch.ops import paint as tpaint
from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_plain

RTOL = 1e-12


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _catalog(n, period, seed, weighted=False):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 1, (n, 3)) * np.asarray(period, 'f8')
    # a few particles exactly on cell edges and on the periodic boundary
    pos[:8] = np.floor(pos[:8])
    pos[8:12, 0] = period[0] - 1e-9
    mass = rng.uniform(0.5, 2.0, n) if weighted else np.ones(n)
    return pos, mass


@pytest.mark.parametrize('resampler', ['nnb', 'cic', 'tsc', 'pcs'])
@pytest.mark.parametrize('block', ['full', 'slab'])
def test_scatter_paint_and_readout_match_jax(resampler, block):
    period = (16, 12, 10)
    shape, origin = ((16, 12, 10), 0) if block == 'full' \
        else ((5, 12, 10), 13)
    pos, mass = _catalog(3000, period, seed=1, weighted=True)
    ref = jpaint.paint_local(jnp.asarray(pos), jnp.asarray(mass), shape,
                             resampler=resampler, period=period,
                             origin=origin)
    got = tpaint.paint_local(torch.as_tensor(pos), torch.as_tensor(mass),
                             shape, resampler=resampler, period=period,
                             origin=origin, chunk=700)
    _close(got.numpy(), ref)
    field = np.random.RandomState(2).normal(size=shape)
    rref = jpaint.readout_local(jnp.asarray(field), jnp.asarray(pos),
                                resampler=resampler, period=period,
                                origin=origin)
    rgot = tpaint.readout_local(torch.as_tensor(field), torch.as_tensor(pos),
                                resampler=resampler, period=period,
                                origin=origin)
    _close(rgot.numpy(), rref)


@pytest.mark.parametrize('resampler', ['cic', 'tsc', 'pcs'])
def test_plain_deposit_matches_pallas_kernel(resampler):
    """The same stripe payload through the Pallas deposit (interpret
    mode) and the port's plain deposit."""
    period = shape = (32, 32, 32)
    pos, mass = _catalog(4000, period, seed=4, weighted=True)
    plan = tpaint.mxu_plan(4000, shape, resampler, period, 8,
                           zchunk_bytes=1 << 14)
    assert plan['npieces'] > 1
    sx, sy, sz, sm, _ = tpaint.mxu_payload(
        torch.as_tensor(pos), torch.as_tensor(mass), plan, resampler, 0,
        'argsort')
    geom = dict(resampler=resampler, rb=plan['rb'], cb=plan['cb'],
                n0l=32, p0=32, N1=32, N2=32, origin=0)
    got = deposit_blocks_plain(sx, sy, sz, sm, ck=plan['ck'], **geom)
    nty, npieces, ck = plan['nty'], plan['npieces'], plan['ck']
    for txi in (1, 2, plan['ntx']):
        def piece(a):
            return jnp.asarray(a[txi].numpy().reshape(nty, npieces, ck))
        ref = deposit_blocks_pallas(
            txi, piece(sx), piece(sy), piece(sz), piece(sm),
            dtype=jnp.float64, interpret=True, **geom)
        _close(got[txi].numpy(), ref)


def _jax_mxu(pos, mass, shape, deposit, **kw):
    return jpaint.paint_local_mxu(jnp.asarray(pos), jnp.asarray(mass), shape,
                                  return_overflow=True, deposit=deposit,
                                  order_method='argsort', **kw)


@pytest.mark.parametrize('resampler', ['cic', 'tsc', 'pcs'])
@pytest.mark.parametrize('block', ['full', 'slab'])
def test_mxu_paint_matches_jax(resampler, block):
    period = (32, 32, 32)
    if block == 'full':
        shape, origin, weighted = period, 0, False
    else:
        shape, origin, weighted = (8, 32, 32), 24, True
    pos, mass = _catalog(4000, period, seed=11, weighted=weighted)
    kw = dict(resampler=resampler, period=period, origin=origin)
    got, over = tpaint.paint_local_mxu(
        torch.as_tensor(pos), torch.as_tensor(mass), shape,
        return_overflow=True, order_method='radix', **kw)
    assert int(over) == 0
    for deposit in ('pallas', 'xla'):
        ref, jover = _jax_mxu(pos, mass, shape, deposit, **kw)
        assert int(jover) == 0
        _close(got.numpy(), ref)
    scatter = tpaint.paint_local(torch.as_tensor(pos), torch.as_tensor(mass),
                                 shape, **kw)
    _close(got.numpy(), scatter.numpy())


def test_mxu_overflow_count_matches_jax():
    period = shape = (32, 32, 32)
    pos, mass = _catalog(4000, period, seed=3)
    kw = dict(resampler='cic', period=period, origin=0, slack=0.5)
    got, over = tpaint.paint_local_mxu(
        torch.as_tensor(pos), torch.as_tensor(mass), shape,
        return_overflow=True, order_method='argsort', **kw)
    ref, jover = _jax_mxu(pos, mass, shape, 'xla', **kw)
    assert int(over) == int(jover) > 0
    _close(got.numpy(), ref)


def test_mxu_order_engines_identical():
    period = shape = (32, 32, 32)
    pos, mass = _catalog(3000, period, seed=8)
    a = tpaint.paint_local_mxu(torch.as_tensor(pos), torch.as_tensor(mass),
                               shape, order_method='radix')
    b = tpaint.paint_local_mxu(torch.as_tensor(pos), torch.as_tensor(mass),
                               shape, order_method='argsort')
    assert torch.equal(a, b)


def test_mxu_scatter_fallback_on_tiny_mesh():
    period = shape = (2, 8, 8)
    pos, mass = _catalog(200, period, seed=9)
    kw = dict(resampler='tsc', period=period, origin=0)
    got = tpaint.paint_local_mxu(torch.as_tensor(pos), torch.as_tensor(mass),
                                 shape, **kw)
    ref = jpaint.paint_local_mxu(jnp.asarray(pos), jnp.asarray(mass), shape,
                                 deposit='xla', **kw)
    _close(got.numpy(), ref)
