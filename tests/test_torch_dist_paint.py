"""The paints and readouts across ranks held to the JAX package's
multi-device paints and readouts at the same P (the main path's CIC
paints, scatter and mxu, and their invariance to the rank count: this
is the one world that paints them), and the eager capacity retries of
both: one world of 4 gloo CPU ranks (``tests/_torch_ranks.py``
``paint_cases``), every rank's part within 1e-12 of the field's largest
value. JAX's references at each P are one jitted program
(``jax_refs``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
import nbodykit_tpu
from nbodykit_tpu.parallel.runtime import cpu_mesh
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts, close = R.parts, R.close


@pytest.fixture(scope='module')
def world():
    return R.run_world('paint_cases')


@functools.lru_cache(maxsize=None)
def jax_refs(P):
    """JAX's multi-device references at P devices, traced as one jitted
    program (one compile a P rather than an eager compile of every
    collective a call): the main path's paints and the readouts, keyed
    ('paint', method) and ('readout', window); every exchange and mxu
    bucket asserted to drop nothing."""
    d = R.particles(R.NPARTS[0])
    pm = JaxPM(R.NMESH, R.BOX, dtype='f8', comm=cpu_mesh(P))
    windows = R.READOUT_WINDOWS if P == 1 else ('cic',)

    @jax.jit
    def refs(pos, mass, real):
        out = {}
        for method, window in R.PAINT_AT_P:
            with nbodykit_tpu.set_options(paint_method=method):
                out['paint', method] = pm.paint(pos, mass, resampler=window,
                                                return_dropped=True)
        for window in windows:
            out['readout', window] = pm.readout(real, pos, resampler=window,
                                                return_dropped=True)
        return out

    got = refs(jnp.asarray(d['pos']), jnp.asarray(d['mass']),
               jnp.asarray(R.readout_field()))
    assert all(int(dropped) == 0 for _, dropped in got.values())
    return {k: np.asarray(v) for k, (v, _) in got.items()}


def jax_paint(method, window, P):
    assert window == dict(R.PAINT_AT_P)[method]
    return jax_refs(P)['paint', method]


def jax_readout(window, P):
    return jax_refs(P)['readout', window]


@pytest.mark.parametrize('method,window,P',
                         [(m, w, P) for P in Ps[1:] for m, w in R.PAINT_AT_P])
def test_paint_equals_jax(world, method, window, P):
    """Each rank's part equals JAX's multi-device paint at P; and the
    paint does not depend on the rank count (tests/test_pmesh.py:133's
    statement across the port's ranks): it equals the port's one rank,
    which equals JAX's one device and holds the catalog's mass."""
    want = jax_paint(method, window, P)
    got = np.concatenate(parts(world, ('paint', method, window), P))
    close(got, want, 1e-12)
    one = world[0]['paint', method, window, 1]
    np.testing.assert_allclose(got, one, rtol=1e-10, atol=1e-12)
    close(one, jax_paint(method, window, 1), 1e-12)
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


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('window', R.READOUT_WINDOWS)
def test_readout_equals_jax(world, window, P):
    want = jax_readout(window, P if window == 'cic' else 1)
    got = np.concatenate(parts(world, ('readout', window), P))
    close(got, want, 1e-12)
