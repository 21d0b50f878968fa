"""Radix rank pass and stable ordering of the PyTorch port against the
JAX package: the plain rank pass against JAX's ``_pass_rank_hist`` and
its Pallas kernel (interpret mode), and ``stable_key_order`` against
JAX's, all bit-identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nbodykit_tpu.ops import radix as jradix
from nbodykit_tpu.ops.radix_pallas import pass_rank_hist_pallas
from nbodykit_tpu_torch.ops import radix as tradix
from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_plain,
                                               raise_on_bad_digits)
from _torch_threads import one_torch_thread  # noqa: F401


def _digits(n, D, seed=5):
    rng = np.random.RandomState(seed)
    return rng.randint(0, D, n).astype('i4')


@pytest.mark.parametrize('n,D', [(1, 1), (1000, 7), (5000, 130),
                                 (4096, 512), (3000, 1024)])
def test_rank_pass_matches_jax_and_pallas(n, D):
    d = _digits(n, D)
    r_t, h_t = pass_rank_hist_plain(torch.as_tensor(d), D, chunk=512)
    r_j, h_j = jradix._pass_rank_hist(jnp.asarray(d), D, 512)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    r_p, h_p = pass_rank_hist_pallas(jnp.asarray(d), D, chunk=512,
                                     interpret=True)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_p))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_p))
    assert r_t.dtype == torch.int32 and h_t.dtype == torch.int32


def test_rank_pass_definition():
    d = _digits(777, 9, seed=2)
    rank, hist = pass_rank_hist_plain(torch.as_tensor(d), 9)
    want = np.array([(d[:i] == d[i]).sum() for i in range(d.size)])
    np.testing.assert_array_equal(rank.numpy(), want)
    np.testing.assert_array_equal(hist.numpy(), np.bincount(d, minlength=9))


@pytest.mark.parametrize('D', [1, 7, 65, 1024, 4161])
@pytest.mark.parametrize('n', [0, 1, 1000, 5000])
def test_stable_key_order_matches_jax(n, D):
    key = _digits(n, D, seed=n + D)
    got = tradix.stable_key_order(torch.as_tensor(key), D)
    want = np.asarray(jradix.stable_key_order(jnp.asarray(key), D))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(key, kind='stable'))


def test_order_keys_engines_agree():
    key = torch.as_tensor(_digits(4000, 4161, seed=1))
    radix = tradix.order_keys(key, 4161, 'radix')
    argsort = tradix.order_keys(key, 4161, 'argsort')
    assert torch.equal(radix, argsort)
    assert torch.equal(tradix.order_keys(key, 4161, 'auto'), argsort)
    with pytest.raises(ValueError):
        tradix.order_keys(key, 4161, 'bogus')


def test_bad_digit_check_is_a_cpu_noop():
    # the device counter exists only on CUDA; on the CPU the rank pass is
    # the plain version and nothing is counted
    assert raise_on_bad_digits('cpu') is None
    assert raise_on_bad_digits(torch.device('cpu')) is None
