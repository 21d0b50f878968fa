"""Counted capacities and the particle exchange across ranks against
the JAX package, bit for bit: one world of 4 gloo CPU ranks
(``tests/_torch_ranks.py`` ``exchange_cases``) answers every case on
``cpu_mesh(1)``, ``cpu_mesh(2)`` and ``cpu_mesh(4)``, held against the
JAX function on ``cpu_mesh(P)`` of this process's 8 virtual devices."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
from nbodykit_tpu.parallel.exchange import auto_capacity as j_auto
from nbodykit_tpu.parallel.exchange import counted_capacity as j_counted
from nbodykit_tpu.parallel.exchange import exchange_by_dest as j_exchange
from nbodykit_tpu.parallel.runtime import cpu_mesh
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts = R.parts


@pytest.fixture(scope='module')
def world():
    return R.run_world('exchange_cases')


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
