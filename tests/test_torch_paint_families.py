"""The sort, segsum and streams paints of the PyTorch port against the
JAX package's, on the same seeded numpy inputs in f8: every resampler,
the three block geometries of ``tests/test_paint_kernels.py`` (a full
block, an origin-offset slab, a slab whose rows wrap the periodic
boundary), segsum under both ordering engines, streams over k in
{1, 3, 4, 9} (9 is clamped to the window's s^3 offsets where s^3 < 9),
and the edge cases: a capped pass count on a long run, no particles,
the int32 guard. Each family is also held to the port's scatter paint,
and ``pmesh.paint`` runs all five methods.

Tolerance: rtol 1e-10, atol 1e-12, the JAX suite's bar for a paint
family against the scatter paint. The JAX side runs eagerly (op by op),
so its compiles are per shape and the file stays at ~25 s."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.ops import paint as jpaint
from nbodykit_tpu_torch.ops import paint as tpaint
from nbodykit_tpu_torch.pmesh import ParticleMesh

RTOL, ATOL = 1e-10, 1e-12
# (n0l, N1, N2, p0, origin), as tests/test_paint_kernels.py GEOMETRIES
GEOMETRIES = [
    (16, 16, 16, 16, 0),
    (12, 16, 16, 32, 5),
    (10, 24, 16, 64, 59),
]
RESAMPLERS = ['nnb', 'cic', 'tsc', 'pcs']
STREAMS = (1, 3, 4, 9)


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def _edge_positions(rng, n, n0l, p0, N1, N2, origin):
    """Uniform positions with x pinned to the block edges, the origin
    and the periodic seam, y / z to their seams (the JAX suite's
    hazards)."""
    pos = rng.uniform(0.0, p0, (n, 3))
    pos[:, 1] = rng.uniform(0.0, N1, n)
    pos[:, 2] = rng.uniform(0.0, N2, n)
    xedges = np.array([0.0, 0.3, p0 - 0.25, origin % p0,
                       (origin + 0.25) % p0, (origin + n0l - 0.25) % p0,
                       (origin + n0l + 0.25) % p0])
    yedges = np.array([0.0, 0.25, N1 - 0.25])
    zedges = np.array([0.0, 0.25, N2 - 0.25])
    ne = min(n // 2, 56)
    pos[:ne, 0] = np.tile(xedges, -(-ne // len(xedges)))[:ne]
    pos[:ne, 1] = np.tile(yedges, -(-ne // len(yedges)))[:ne]
    pos[:ne, 2] = np.tile(zedges, -(-ne // len(zedges)))[:ne]
    return pos


def _cases(resampler, seed):
    rng = np.random.default_rng(seed)
    for (n0l, N1, N2, p0, origin) in GEOMETRIES:
        pos = _edge_positions(rng, 400, n0l, p0, N1, N2, origin)
        mass = rng.uniform(0.5, 2.0, 400)
        yield pos, mass, (n0l, N1, N2), dict(
            resampler=resampler, period=(p0, N1, N2), origin=origin)


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _run(fn, pos, mass, shape, kw, **more):
    return fn(torch.as_tensor(pos), torch.as_tensor(mass), shape, **kw,
              **more)


@pytest.mark.parametrize('resampler', RESAMPLERS)
def test_sort_and_segsum_match_jax(resampler):
    """sort, and segsum with argsort and radix, against JAX's (segsum
    under the same engine for cic, the argsort result otherwise: both
    engines are stable, so JAX's two agree bit for bit) and against the
    port's scatter paint."""
    for pos, mass, shape, kw in _cases(resampler, 42):
        jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
        what = '%s %s' % (resampler, shape)
        scatter = _run(tpaint.paint_local, pos, mass, shape, kw)
        ref = jpaint.paint_local_sorted(jpos, jmass, shape, **kw)
        got = _run(tpaint.paint_local_sorted, pos, mass, shape, kw)
        _close(got, ref, 'sort ' + what)
        _close(got, scatter, 'sort vs scatter ' + what)
        ref = jpaint.paint_local_segsum(jpos, jmass, shape,
                                        order_method='argsort', **kw)
        for order in ('argsort', 'radix'):
            if order == 'radix' and resampler == 'cic':
                ref = jpaint.paint_local_segsum(
                    jpos, jmass, shape, order_method='radix', **kw)
            got = _run(tpaint.paint_local_segsum, pos, mass, shape, kw,
                       order_method=order)
            _close(got, ref, 'segsum %s %s' % (order, what))
            _close(got, scatter, 'segsum %s vs scatter %s' % (order, what))


@pytest.mark.parametrize('resampler', RESAMPLERS)
def test_streams_match_jax(resampler):
    """streams over k in {1, 3, 4, 9} (clamped to s^3) against JAX's,
    chunked (101 particles a pass) at k = 4 for cic, and against
    scatter."""
    for pos, mass, shape, kw in _cases(resampler, 7):
        jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
        scatter = _run(tpaint.paint_local, pos, mass, shape, kw)
        for k in STREAMS:
            chunk = 101 if k == 4 and resampler == 'cic' else None
            ref = jpaint.paint_local_streams(jpos, jmass, shape, streams=k,
                                             chunk=chunk, **kw)
            got = _run(tpaint.paint_local_streams, pos, mass, shape, kw,
                       streams=k, chunk=chunk)
            what = 'streams %d %s %s' % (k, resampler, shape)
            _close(got, ref, what)
            _close(got, scatter, what + ' vs scatter')


def test_sort_pass_cap_empty_catalog_and_accumulator_as_jax():
    """npasses=1 leaves a run of 5 partly summed, as JAX's does; no
    particles paints nothing (or only ``out``); ``out`` is accumulated
    onto by every family."""
    shape = (8, 8, 8)
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 8, (40, 3))
    pos[:5] = [2.25, 3.5, 4.75]                # a run of 5 in one cell
    mass = rng.uniform(0.5, 2.0, 40)
    kw = dict(resampler='cic', period=shape, origin=0)
    ref = jpaint.paint_local_sorted(jnp.asarray(pos), jnp.asarray(mass),
                                    shape, npasses=1, **kw)
    got = _run(tpaint.paint_local_sorted, pos, mass, shape, kw, npasses=1)
    _close(got, ref, 'npasses=1')
    full = _run(tpaint.paint_local_sorted, pos, mass, shape, kw)
    assert not np.allclose(got.numpy(), full.numpy()), \
        'one pass should not finish a run of 5'

    out = torch.as_tensor(rng.normal(size=shape))
    empty_pos, empty_mass = np.zeros((0, 3)), np.zeros(0)
    for name, fn, more in (('sort', tpaint.paint_local_sorted, {}),
                           ('segsum', tpaint.paint_local_segsum,
                            dict(order_method='radix')),
                           ('streams', tpaint.paint_local_streams,
                            dict(streams=3))):
        jfn = getattr(jpaint, 'paint_local_' + ('sorted' if name == 'sort'
                                                else name))
        ref = jfn(jnp.zeros((0, 3)), jnp.zeros(0), shape, **kw)
        got = _run(fn, empty_pos, empty_mass, shape, kw, **more)
        assert got.shape == shape and not got.any(), name
        _close(got, ref, name + ' n=0')
        got = _run(fn, empty_pos, empty_mass, shape, kw, out=out, **more)
        _close(got, out.numpy(), name + ' n=0 out')
        got = _run(fn, pos, mass, shape, kw, out=out, **more)
        _close(got, (full + out).numpy(), name + ' out')


@pytest.mark.parametrize('fn', ['paint_local_sorted', 'paint_local_segsum'])
def test_int32_guard_raises_as_jax(fn):
    """A block past the int32 flat index raises the same ValueError in
    both packages, before anything mesh-sized is allocated."""
    shape = (2048, 1024, 1024)
    pos = np.full((4, 3), 0.5)
    with pytest.raises(ValueError, match='overflows the int32') as jerr:
        getattr(jpaint, fn)(jnp.asarray(pos), jnp.ones(4), shape)
    with pytest.raises(ValueError, match='overflows the int32') as terr:
        getattr(tpaint, fn)(torch.as_tensor(pos),
                            torch.ones(4, dtype=torch.float64), shape)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize('method', ['scatter', 'mxu', 'sort', 'segsum',
                                    'streams'])
def test_pmesh_paints_every_method(method):
    """``pmesh.paint`` runs all five methods; each equals the scatter
    paint in f8, mass conserved."""
    rng = np.random.default_rng(11)
    pos = torch.as_tensor(rng.uniform(0, 50.0, (3000, 3)))
    mass = torch.as_tensor(rng.uniform(0.5, 2.0, 3000))
    pm = ParticleMesh(16, 50.0, dtype='f8', device='cpu')
    with nbodykit_tpu_torch.set_options(paint_method='scatter'):
        ref = pm.paint(pos, mass, resampler='tsc')
    with nbodykit_tpu_torch.set_options(paint_method=method,
                                        paint_order='radix',
                                        paint_streams=5):
        got = pm.paint(pos, mass, resampler='tsc')
    assert got.dtype == torch.float64
    _close(got, ref.numpy(), method)
    assert float(got.sum()) == pytest.approx(float(mass.sum()), rel=1e-12)


def test_options_accept_the_families_and_refuse_bad_values():
    set_options = nbodykit_tpu_torch.set_options
    for method in ('auto', 'scatter', 'mxu', 'sort', 'segsum', 'streams'):
        with set_options(paint_method=method):
            pass
    for dtype in ('auto', 'f4', 'f8', 'bf16'):
        with set_options(mesh_dtype=dtype):
            assert nbodykit_tpu_torch.resolve_mesh_dtype() == (
                'f4' if dtype == 'auto' else dtype)
    with set_options(paint_streams='auto'):
        cfg = nbodykit_tpu_torch.resolve_paint(torch.device('cpu'))
        assert cfg['paint_streams'] == 4
    with set_options(paint_streams=np.int64(7)):
        assert nbodykit_tpu_torch.resolve_paint(
            torch.device('cpu'))['paint_streams'] == 7
    for key, bad in (('paint_method', 'pallas'), ('paint_method', None),
                     ('mesh_dtype', 'f2'), ('mesh_dtype', 'bfloat'),
                     ('paint_order', 'bitonic'), ('paint_streams', 0),
                     ('paint_streams', -2), ('paint_streams', 2.5),
                     ('paint_streams', True), ('paint_streams', '4')):
        with pytest.raises(ValueError, match=key):
            set_options(**{key: bad})
        with pytest.raises(ValueError, match=key):
            with nbodykit_tpu_torch.option_scope(**{key: bad}):
                pass
    assert nbodykit_tpu_torch._global_options['paint_streams'] == 'auto'
    assert nbodykit_tpu_torch._global_options['mesh_dtype'] == 'f4'
