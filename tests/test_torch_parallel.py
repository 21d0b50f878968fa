"""The rank substrate of the torch port against the JAX package: halos,
the slab FFT (and its compressed wire formats), paints and readouts
across ranks, the per-rank draws, the gather and scatter of arrays, the
memory plan, each collective's backward under autograd, and the calls
that refuse ranks.

One world of 4 gloo CPU ranks (``tests/_torch_ranks.py``
``parallel_cases``) answers every case on ``cpu_mesh(1)``,
``cpu_mesh(2)`` and ``cpu_mesh(4)``; each rank's part is held against
the same rows of the JAX function's result on ``cpu_mesh(P)`` of this
process's 8 virtual devices. Bars: halos bit for bit; transforms f8
within 1e-10 relative; paints and readouts within 1e-12 of the field's
largest value; draws bit for bit; the adjoints' dot products within
1e-12. The capacities and the exchange, and the main path's paints and
readouts (held to JAX's multi-device ones), are in
test_torch_dist_exchange.py and test_torch_dist_paint.py (files of few
tests, which the test runner's file scheduling starts after the long
JAX files).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
import nbodykit_tpu
from nbodykit_tpu.parallel import dfft as jdfft
from nbodykit_tpu.parallel.halo import halo_add as j_halo_add
from nbodykit_tpu.parallel.halo import halo_fill as j_halo_fill
from nbodykit_tpu.parallel.runtime import AXIS, cpu_mesh
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from nbodykit_tpu.pmesh import memory_plan as j_memory_plan
from nbodykit_tpu.rng import DistributedRNG as JaxRNG
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JaxUniform
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch.pmesh import memory_plan
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts, close = R.parts, R.close


@pytest.fixture(scope='module')
def world():
    return R.run_world('parallel_cases')


def rank_rows(a, P):
    return [R.rows(a, P, r) for r in range(P)]


def rank_slabs(a, P):
    return [R.slab(a, P, r) for r in range(P)]


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


# the main path's paints (R.PAINT_AT_P) are painted and held against JAX
# at every rank count in test_torch_dist_paint.py's world; the others
# here, against JAX's one-device paint and, through
# test_paint_rank_count_invariance, against the port's one-rank paint (a
# JAX multi-device paint compiles for 13-35 s on this CPU)
OTHER_PAINTS = [c for c in R.PAINT_CASES if c not in R.PAINT_AT_P]
ONE_DEVICE_PAINTS = [(m, w, P) for P in Ps for m, w in OTHER_PAINTS]


@pytest.mark.parametrize('method,window,P', ONE_DEVICE_PAINTS)
def test_paint_equals_jax(world, method, window, P):
    want = jax_paint(method, window, 1)
    got = np.concatenate(parts(world, ('paint', method, window), P))
    close(got, want, 1e-12)


@pytest.mark.parametrize('method,window', OTHER_PAINTS)
def test_paint_rank_count_invariance(world, method, window):
    """tests/test_pmesh.py:133's statement, across the port's ranks."""
    one = world[0]['paint', method, window, 1]
    for P in Ps[1:]:
        got = np.concatenate(parts(world, ('paint', method, window), P))
        np.testing.assert_allclose(got, one, rtol=1e-10, atol=1e-12)
    assert np.isclose(one.sum(), R.particles(R.NPARTS[0])['mass'].sum(),
                      rtol=1e-12)


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
    running on a rank's rows alone; the FFT bispectrum and the forward
    model run across ranks (below), FOF, HaloCatalog, KDDensity and the
    sort too (test_torch_dist_particles.py), and the direct bispectrum,
    the 3PCF, CGM, FiberCollisions and PopulatedHaloCatalog
    (test_torch_dist_groups.py)."""
    want = sorted(['save', 'poisson'])
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


@pytest.mark.parametrize('P', Ps[1:])
def test_forward_model_refuses_indivisible_lattice(world, P):
    """ng and nmesh must be divisible by the rank count: a ValueError
    naming it, before any collective (ng = 3 at P = 2 and 4; nmesh 6
    at P = 4)."""
    want = [True] if P == 2 else [True, True]
    assert parts(world, ('forward_refuses',), P) == [want] * P


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


@pytest.mark.parametrize('ndev', [1, 2, 4])
@pytest.mark.parametrize('workload', ['forward', 'bispectrum'])
def test_memory_plan_workloads_equal_jax(workload, ndev):
    """The forward-model and bispectrum workloads: the JAX formulas,
    key for key, over pm_steps, nbins, both bispectrum methods and a
    given or default pairblock tile."""
    if workload == 'forward':
        grid = [dict(pm_steps=s) for s in (None, 1, 2, 5)]
    else:
        grid = [dict(nbins=nb, bspec_method=m, pairblock_tile=t)
                for nb in (None, 4, 16) for m in ('fft', 'direct')
                for t in (None, 256)]
    for kw in grid:
        for nmesh, npart in ((128, 128 ** 3), (256, 1e7)):
            for dtype in ('f4', 'f8'):
                for method in ('scatter', 'mxu'):
                    kw = dict(kw, ndevices=ndev, dtype=dtype,
                              paint_method=method, hbm_bytes=80e9,
                              workload=workload)
                    got = memory_plan(nmesh, npart, **kw)
                    assert got == j_memory_plan(nmesh, npart, **kw), kw
                    assert got['workload'] == workload


def test_memory_plan_reads_the_card():
    if torch.cuda.is_available():
        want = torch.cuda.get_device_properties(0).total_memory
        assert memory_plan(64, 1e5)['budget_bytes'] == 0.85 * want
    else:
        with pytest.raises((ValueError, RuntimeError)):
            memory_plan(64, 1e5)


# -- the collectives under autograd -------------------------------------------

ADJOINTS = ['transpose_real', 'transpose_cplx', 'inverse_transpose_real',
            'inverse_transpose_cplx', 'route', 'loss_sum'] + [
    'halo_%s_%d' % (op, h) for op in ('add', 'fill') for h in R.HALO_WIDTHS]


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('name', ADJOINTS)
def test_collective_backward_is_its_adjoint(world, name, P):
    """<A x, y> = <x, A^T y> with A^T y the autograd backward, summed
    over the ranks: the transposes' backward is the inverse transpose,
    a route's the route back, halo_add's halo_fill and the reverse; the
    loss sum's backward is 1 on every rank, once."""
    got = parts(world, ('adjoint', name), P)
    for ax_y, x_aty in got:
        assert abs(ax_y - x_aty) <= 1e-12 * max(abs(ax_y), abs(x_aty))
        assert (ax_y, x_aty) == got[0]


@pytest.mark.parametrize('P', Ps[1:])
def test_compressed_wire_refuses_autograd(world, P):
    assert all(parts(world, ('compressed_grad_refused',), P))


@pytest.mark.parametrize('P', Ps)
def test_all_reduce_refuses_autograd(world, P):
    """A global sum scaling this rank's slab needs the ranks'
    cotangents summed in its backward; all_reduce refuses autograd
    rather than give each rank only its own part."""
    assert all(parts(world, ('local_consumer_refused',), P))
