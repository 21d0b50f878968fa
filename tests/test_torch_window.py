"""Windows and compensation of the PyTorch port against the JAX package,
on positions with negative and wrapped cells (f8, rtol 1e-13)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbodykit_tpu.ops import window as jwin
from nbodykit_tpu_torch.ops import window as twin

RESAMPLERS = ['nnb', 'cic', 'tsc', 'pcs']


def _positions():
    rng = np.random.RandomState(7)
    x = rng.uniform(-6.0, 40.0, 2000)
    # cell edges and centres, where the base cell flips
    edges = np.arange(-3, 35, 0.5)
    return np.concatenate([x, edges, edges + 1e-12, edges - 1e-12])


@pytest.mark.parametrize('resampler', RESAMPLERS)
def test_window_weights_match_jax(resampler):
    x = _positions()
    ji, jw = jwin.window_weights(jnp.asarray(x), resampler)
    ti, tw = twin.window_weights(torch.as_tensor(x), resampler)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_array_equal(
        twin.window_base(torch.as_tensor(x), resampler).numpy(),
        np.asarray(jwin.window_base(jnp.asarray(x), resampler)))
    assert twin.window_support(resampler) == jwin.window_support(resampler)


@pytest.mark.parametrize('resampler', RESAMPLERS)
def test_window_weights_f4_bases_match_jax(resampler):
    x = _positions().astype('f4')
    ji, jw = jwin.window_weights(jnp.asarray(x), resampler)
    ti, tw = twin.window_weights(torch.as_tensor(x), resampler)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('resampler', RESAMPLERS)
@pytest.mark.parametrize('interlaced', [False, True])
def test_compensation_matches_jax(resampler, interlaced):
    rng = np.random.RandomState(3)
    w = [rng.uniform(-np.pi, np.pi, (5, 1, 1)),
         rng.uniform(-np.pi, np.pi, (1, 6, 1)),
         np.linspace(0, np.pi, 7).reshape(1, 1, 7)]
    v = rng.normal(size=(5, 6, 7)) + 1j * rng.normal(size=(5, 6, 7))
    jt = jwin.compensation_transfer(resampler, interlaced)
    tt = twin.compensation_transfer(resampler, interlaced)
    ref = np.asarray(jt([jnp.asarray(a) for a in w], jnp.asarray(v)))
    got = tt([torch.as_tensor(a) for a in w], torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13)


def test_unknown_resampler_raises():
    with pytest.raises(ValueError):
        twin.window_support('lanczos')
