"""The rank substrate of the torch port against the JAX package: counted
capacities, the exchange, halos, the slab FFT (and its compressed wire
formats), paints and readouts across ranks, the per-rank draws, and the
gather and scatter of arrays.

One world of 4 gloo CPU ranks (``tests/_torch_ranks.py``) answers every
case on ``cpu_mesh(1)``, ``cpu_mesh(2)`` and ``cpu_mesh(4)``; each
rank's part is held against the same rows of the JAX function's result
on ``cpu_mesh(P)`` of this process's 8 virtual devices. Bars: integers,
capacities, exchange buffers and halos bit for bit; transforms f8 within
1e-10 relative; paints and readouts within 1e-12 of the field's largest
value; draws bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
import nbodykit_tpu
from nbodykit_tpu.parallel import dfft as jdfft
from nbodykit_tpu.parallel.exchange import auto_capacity as j_auto
from nbodykit_tpu.parallel.exchange import counted_capacity as j_counted
from nbodykit_tpu.parallel.exchange import exchange_by_dest as j_exchange
from nbodykit_tpu.parallel.halo import halo_add as j_halo_add
from nbodykit_tpu.parallel.halo import halo_fill as j_halo_fill
from nbodykit_tpu.parallel.runtime import AXIS, cpu_mesh
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from nbodykit_tpu.pmesh import memory_plan as j_memory_plan
from nbodykit_tpu.rng import DistributedRNG as JaxRNG
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JaxUniform
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch.pmesh import memory_plan

Ps = R.RANK_COUNTS


@pytest.fixture(scope='module')
def world():
    return R.run_world('parallel_cases')


def parts(world, key, P):
    """Each rank's result of case ``key`` at P ranks, in rank order."""
    return [world[r][key + (P,)] for r in range(P)]


def rank_rows(a, P):
    return [R.rows(a, P, r) for r in range(P)]


def rank_slabs(a, P):
    return [R.slab(a, P, r) for r in range(P)]


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# -- capacities and the exchange ----------------------------------------------

@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('n', R.NPARTS)
def test_capacities_equal_jax(world, n, P):
    d = R.particles(n)
    dest = jnp.asarray(d['dest'] % P)
    want = j_auto(dest, P) if P > 1 else None
    cells = jnp.asarray(d['pos'] * (R.NMESH / R.BOX))
    counted = j_counted(P, cells, n0=R.NMESH // P)
    jpm = JaxPM(R.NMESH, R.BOX, dtype='f8', comm=cpu_mesh(P))
    shifted = {s: jpm.exchange_capacity(jnp.asarray(d['pos']), shift=s)
               for s in (0.0, 0.5)}
    for r in range(P):
        if P > 1:
            assert world[r]['auto_capacity', n, P] == want
        assert world[r]['counted_capacity', n, P] == counted
        for s, cap in shifted.items():
            assert world[r]['exchange_capacity', n, s, P] == cap


@functools.lru_cache(maxsize=None)
def jax_exchange(n, cap, P):
    d = R.particles(n)
    recv, valid, dropped = j_exchange(
        jnp.asarray(d['dest'] % P), [jnp.asarray(d['pos']),
                                     jnp.asarray(d['mass'])],
        cpu_mesh(P), cap)
    return ([np.asarray(a) for a in recv], np.asarray(valid),
            int(dropped))


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('n,cap', [(R.NPARTS[0], None), (R.NPARTS[1], None),
                                   (R.NPARTS[1], R.SMALL_CAPACITY)])
def test_exchange_equals_jax_bit_for_bit(world, n, cap, P):
    (pos, mass), valid, dropped = jax_exchange(n, cap, P)
    got = parts(world, ('exchange', n, cap), P)
    if cap is not None and P > 1:
        assert dropped > 0
    for r, g in enumerate(got):
        block = slice(r * len(g['valid']), (r + 1) * len(g['valid']))
        np.testing.assert_array_equal(g['valid'], valid[block])
        np.testing.assert_array_equal(g['pos'], pos[block])
        np.testing.assert_array_equal(g['mass'], mass[block])
        assert g['dropped'] == dropped


# -- halos ------------------------------------------------------------------

def _jax_halo(fn, arr, h, P):
    import jax
    from jax.sharding import PartitionSpec as Ps_
    out = jax.shard_map(lambda e: fn(e, h, P), mesh=cpu_mesh(P),
                        in_specs=Ps_(AXIS), out_specs=Ps_(AXIS))(
        jnp.asarray(arr))
    return np.asarray(out)


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('h', R.HALO_WIDTHS)
def test_halo_add_equals_jax(world, h, P):
    ext, _ = R.halo_blocks(P, h)
    want = _jax_halo(j_halo_add, ext, h, P)
    got = np.concatenate(parts(world, ('halo_add', h), P))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('h', R.HALO_WIDTHS)
def test_halo_fill_equals_jax(world, h, P):
    _, interior = R.halo_blocks(P, h)
    want = _jax_halo(j_halo_fill, interior, h, P)
    got = np.concatenate(parts(world, ('halo_fill', h), P))
    np.testing.assert_array_equal(got, want)


# -- the slab FFT -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_transforms(P, mode='none'):
    fin = R.fft_inputs()
    mesh = cpu_mesh(P)
    with nbodykit_tpu.set_options(a2a_compress=mode):
        y = jdfft.dist_rfftn(jnp.asarray(fin['real']), mesh)
        out = {'rfftn': as_numpy(y)}
        if mode != 'none':
            return out
        out['irfftn'] = np.asarray(jdfft.dist_irfftn(y, R.FFT_SHAPE[2],
                                                     mesh))
        yc = jdfft.dist_fftn_c2c(jnp.asarray(fin['cplx']), mesh)
        out['c2c'] = as_numpy(yc)
        out['ic2c'] = as_numpy(jdfft.dist_fftn_c2c(yc, mesh, inverse=True))
    return out


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('kind', ['rfftn', 'irfftn', 'c2c', 'ic2c'])
def test_transforms_equal_jax(world, kind, P):
    want = jax_transforms(P)[kind]
    got = np.concatenate(parts(world, (kind,), P))
    close(got, want, 1e-10)


# the JAX package's P(k) budgets of the compressed wire formats
# (tests/test_precision.py BUDGETS), here on the transformed field
A2A_BARS = {'bf16': 1e-2, 'int16': 5e-4}


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('mode', R.A2A_MODES)
def test_compressed_transforms_match_jax_mode(world, mode, P):
    exact = jax_transforms(P)['rfftn']
    want = jax_transforms(P, mode)['rfftn']
    got = np.concatenate(parts(world, ('rfftn', mode), P))
    close(got, want, A2A_BARS[mode])
    close(got, exact, A2A_BARS[mode])
    if P > 1:
        assert np.abs(got - exact).max() > 0      # the wire did compress


# -- paint and readout --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_paint(method, window, P, capacity=None):
    d = R.particles(R.NPARTS[0])
    pm = JaxPM(R.NMESH, R.BOX, dtype='f8', comm=cpu_mesh(P))
    with nbodykit_tpu.set_options(paint_method=method):
        return np.asarray(pm.paint(jnp.asarray(d['pos']),
                                   jnp.asarray(d['mass']),
                                   resampler=window, capacity=capacity))


# the main path's paints are held against JAX at every rank count; the
# others against JAX's one-device paint and, through
# test_paint_rank_count_invariance, against the port's one-rank paint
# (a JAX multi-device paint compiles for 13-35 s on this CPU)
PAINT_AT_P = (('scatter', 'cic'), ('mxu', 'cic'))


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('method,window', R.PAINT_CASES)
def test_paint_equals_jax(world, method, window, P):
    jp = P if (method, window) in PAINT_AT_P else 1
    want = jax_paint(method, window, jp)
    got = np.concatenate(parts(world, ('paint', method, window), P))
    close(got, want, 1e-12)


@pytest.mark.parametrize('method,window', R.PAINT_CASES)
def test_paint_rank_count_invariance(world, method, window):
    """tests/test_pmesh.py:133's statement, across the port's ranks."""
    one = world[0]['paint', method, window, 1]
    for P in Ps[1:]:
        got = np.concatenate(parts(world, ('paint', method, window), P))
        np.testing.assert_allclose(got, one, rtol=1e-10, atol=1e-12)
    assert np.isclose(one.sum(), R.particles(R.NPARTS[0])['mass'].sum(),
                      rtol=1e-12)


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('case', ['paint_retry', 'readout_retry'])
def test_capacity_retry(world, case, P):
    """An explicit capacity too small for the exchange is doubled until
    nothing drops, as in the JAX package, and ends at the field (the
    values) of the exact capacity."""
    got = parts(world, (case,), P)
    if case == 'paint_retry':
        want = jax_paint('scatter', 'cic', P)
    else:
        want = jax_readout('cic', P)
    close(np.concatenate([g['value'] for g in got]), want, 1e-12)
    # capacity 4, doubled until no particle drops
    for g in got:
        assert g['retries'] == (0 if P == 1 else
                                int(np.log2(g['capacity'] // 4))), g


@functools.lru_cache(maxsize=None)
def jax_readout(window, P):
    d = R.particles(R.NPARTS[0])
    pm = JaxPM(R.NMESH, R.BOX, dtype='f8', comm=cpu_mesh(P))
    return np.asarray(pm.readout(jnp.asarray(R.readout_field()),
                                 jnp.asarray(d['pos']), resampler=window))


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('window', R.READOUT_WINDOWS)
def test_readout_equals_jax(world, window, P):
    want = jax_readout(window, P if window == 'cic' else 1)
    got = np.concatenate(parts(world, ('readout', window), P))
    close(got, want, 1e-12)


@pytest.mark.parametrize('P', Ps)
def test_readout_of_rows_split_unevenly(world, P):
    """4099 particles, so the ranks hold different row counts: every
    exchange pad goes back to a spare row of its receiver, and the
    values equal JAX's one-device readout. ``readout_many`` of two
    fields routes the particles once and equals a readout of each, bit
    for bit."""
    pos = R.particles(R.NPARTS[1])['pos']
    want = np.asarray(JaxPM(R.NMESH, R.BOX, dtype='f8').readout(
        jnp.asarray(R.readout_field()), jnp.asarray(pos), resampler='cic'))
    close(np.concatenate(parts(world, ('readout_uneven',), P)), want, 1e-12)
    for r in range(P):
        one, two = world[r]['readout_many', P]
        np.testing.assert_array_equal(two, world[r]['readout_one', P])
        np.testing.assert_array_equal(two, 2 * one)
    assert sum(len(g) for g in parts(world, ('readout_uneven',), P)) == \
        len(pos)


# -- per-rank draws and grids -------------------------------------------------

@pytest.mark.parametrize('P', Ps)
def test_whitenoise_equals_jax(world, P):
    want = as_numpy(JaxPM(R.NMESH, R.BOX, dtype='f8').generate_whitenoise(7))
    got = np.concatenate(parts(world, ('whitenoise',), P))
    close(got, want, 1e-12)
    close(got, world[0]['whitenoise', 1], 1e-12)


@pytest.mark.parametrize('P', Ps[1:])
def test_drawn_seed_is_rank_0s(world, P):
    """LinearMesh(seed=None) draws its seed on every rank from that
    rank's numpy state and takes rank 0's, so every rank draws the same
    realization."""
    seeds = [world[r]['drawn_seed', P] for r in range(P)]
    assert len(set(seeds)) == 1, seeds


@pytest.mark.parametrize('P', Ps)
def test_particle_grid_rows_equal_jax(world, P):
    want = as_numpy(JaxPM(8, R.BOX, comm=cpu_mesh(P))
                    .generate_uniform_particle_grid())
    got = np.concatenate(parts(world, ('particle_grid',), P))
    np.testing.assert_array_equal(got, want)
    for g, w in zip(parts(world, ('particle_grid',), P),
                    rank_rows(want, P)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('P', Ps)
def test_uniform_catalog_rows_equal_jax(world, P):
    cat = JaxUniform(nbar=0.03, BoxSize=R.BOX, seed=42, comm=cpu_mesh(P))
    got = parts(world, ('uniform',), P)
    for col in ('Position', 'Velocity'):
        want = np.asarray(cat[col])
        for g, w in zip(got, rank_rows(want, P)):
            np.testing.assert_array_equal(g[col], w)
    for g in got:
        assert g['csize'] == cat.csize
    np.testing.assert_array_equal(
        np.concatenate([g['Index'] for g in got]), np.asarray(cat['Index']))
    sl = parts(world, ('gslice',), P)
    want = np.asarray(cat.gslice(5, cat.csize - 7, 3)['Position'])
    np.testing.assert_array_equal(
        np.concatenate([g['Position'] for g in sl]), want)
    assert all(g['csize'] == len(want) for g in sl)


@pytest.mark.parametrize('P', Ps)
def test_distributed_rng_rows(world, P):
    """Each rank's rows equal the one-rank draw's bit for bit; uniform
    and choice equal JAX's, the f4 normals within the port's few ulp."""
    rng = JaxRNG(11, 1001, comm=cpu_mesh(P))
    want = {'uniform': np.asarray(rng.uniform(itemshape=(3,))),
            'normal': np.asarray(rng.normal(dtype='f4')),
            'choice': np.asarray(rng.choice(7, p=jnp.arange(7.0) / 21.0))}
    got = parts(world, ('drng',), P)
    one = world[0]['drng', 1]
    for k, w in want.items():
        cat = np.concatenate([g[k] for g in got])
        np.testing.assert_array_equal(cat, one[k])
        if k == 'normal':
            np.testing.assert_allclose(cat, w, rtol=0, atol=4e-6)
        else:
            np.testing.assert_array_equal(cat, w)


@pytest.mark.parametrize('P', Ps[1:])
def test_unported_branches_refuse_ranks(world, P):
    """Every call with no multi-rank branch yet raises instead of
    running on a rank's rows alone; ``forward_slabs`` runs across ranks
    now (tests/test_torch_dist_fftpower.py, ConvolvedFFTPower)."""
    want = sorted(['FOF', 'KDDensity', 'sort', 'save', 'poisson',
                   'Bispectrum', 'ForwardModel', 'PopulatedHaloCatalog',
                   'HaloCatalog'])
    for r in range(P):
        assert world[r]['refused', P] == want


# -- gather, scatter, bounds --------------------------------------------------

@pytest.mark.parametrize('P', Ps)
def test_scatter_gather_round_trip(world, P):
    whole = R.particles(R.NPARTS[0])['pos']
    got = parts(world, ('scatter',), P)
    for g, w in zip(got, rank_rows(whole, P)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(world[0]['gather', P], whole)
    assert all(world[r]['gather', P] is None for r in range(1, P))
    for r in range(P):
        lo, hi = world[r]['bounds', P]
        np.testing.assert_array_equal(lo, whole.min(axis=0))
        np.testing.assert_array_equal(hi, whole.max(axis=0))


# -- memory plan ----------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['f4', 'f8', 'bf16'])
@pytest.mark.parametrize('method', ['scatter', 'sort', 'segsum', 'streams',
                                    'mxu'])
def test_memory_plan_equals_jax(method, dtype):
    for nmesh in (64, 512, (1024, 1024, 512)):
        for npart in (1e5, 1e8):
            for ndev in (1, 2, 4, 16):
                for exchange in ('counted', 'ceil'):
                    kw = dict(ndevices=ndev, dtype=dtype,
                              paint_method=method, hbm_bytes=80e9,
                              exchange=exchange)
                    assert memory_plan(nmesh, npart, **kw) == \
                        j_memory_plan(nmesh, npart, **kw), kw


def test_memory_plan_reads_the_card():
    if torch.cuda.is_available():
        want = torch.cuda.get_device_properties(0).total_memory
        assert memory_plan(64, 1e5)['budget_bytes'] == 0.85 * want
    else:
        with pytest.raises((ValueError, RuntimeError)):
            memory_plan(64, 1e5)
