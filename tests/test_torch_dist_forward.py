"""The differentiable forward model across ranks: ``ForwardModel(16,
512, BoxSize=100, f8)`` at pm_steps 1 and 2, order 1 and 2, its density
of the JAX model's truth modes and the loss's value and gradient at a
seeded white leaf (both carried in through ``convert.py``), held to JAX
at P = 1 (1e-10 of each largest value) and to the port's one rank at P
= 2 and 4 (the gradient 1e-9); central differences of the gradient and
two Adam steps of ``recover`` across ranks. One world of 4 gloo CPU
ranks (``tests/_torch_ranks.py`` ``forward_program``). The JAX side
runs eagerly: a compiled value and gradient takes longer to compile than
to run at this size."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
import nbodykit_tpu.forward as J
from nbodykit_tpu.utils import as_numpy
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts, close = R.parts, R.close


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('forward') / 'modes.npy')
    np.save(path, jax_truth_modes())
    return R.run_world('forward_program', args=(path,))


@functools.lru_cache(maxsize=None)
def jax_model(steps, order, nmesh=R.FW_NMESH):
    return R.forward_model(J.ForwardModel, steps, order, nmesh=nmesh)


@functools.lru_cache(maxsize=None)
def jax_truth_modes():
    return as_numpy(jax_model(1, 1).linear_modes(R.MODES_SEED))


@functools.lru_cache(maxsize=None)
def jax_forward(steps, order):
    """The density of the truth modes, and the loss's value and gradient
    at the white leaf, eagerly."""
    m = jax_model(steps, order)
    inp = R.forward_inputs()
    loss = J.make_loss(m, jnp.asarray(inp['obs']), noise_std=R.FW_NOISE)
    v, g = jax.value_and_grad(loss)(jnp.asarray(inp['white']))
    d = m.density(jnp.asarray(jax_truth_modes()))
    return dict(density=np.asarray(d), value=float(v), grad=np.asarray(g))


def gathered(world, key, P, field):
    return np.concatenate([g[field] for g in parts(world, key, P)])


@pytest.mark.parametrize('P', Ps)
@pytest.mark.parametrize('steps,order', R.FW_CONFIGS)
def test_forward_model_across_ranks(world, steps, order, P):
    """The density, the loss and its gradient: JAX's at one rank (1e-10
    of each largest value), the port's one rank at P = 2 and 4 (the
    gradient 1e-9); the loss is the same on every rank."""
    key = ('forward', steps, order)
    if P == 1:
        want, grad_tol = jax_forward(steps, order), 1e-10
    else:
        want, grad_tol = world[0][key + (1,)], 1e-9
    close(gathered(world, key, P, 'density'), want['density'], 1e-10)
    close(gathered(world, key, P, 'grad'), want['grad'], grad_tol)
    for g in parts(world, key, P):
        assert g['value'] == pytest.approx(want['value'], rel=1e-10)
        assert g['value'] == world[0][key + (P,)]['value']


@pytest.mark.parametrize('P', Ps[1:])
def test_forward_gradient_central_differences(world, P):
    """The gradient along a seeded unit direction against central
    differences of the loss (eps 1e-6), across ranks, at
    tests/test_forward.py's bar."""
    for g in parts(world, ('forward', 2, 2), P):
        fd, dot = g['fd'], g['grad_dot']
        assert abs(fd - dot) <= 1e-4 * max(abs(fd), abs(dot), 1e-10)


@pytest.mark.parametrize('P', Ps[1:])
def test_recover_across_ranks(world, P):
    """Two Adam steps: the losses and the leaf of the one-rank run."""
    one = world[0]['forward', 1, 2, 1]['recover']
    got = [g['recover'] for g in parts(world, ('forward', 1, 2), P)]
    for g in got:
        np.testing.assert_allclose(g['losses'], one['losses'], rtol=1e-10)
        assert g['losses'][-1] < g['losses'][0]
    close(np.concatenate([g['white'] for g in got]), one['white'], 1e-9)
