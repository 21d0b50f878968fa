"""The port's Spectra surface, backed by its Boltzmann engine, against the
JAX package's (x64 on): sigma8, sigma8_z, get_pklin, get_transfer,
``match(sigma8=...)``, the halofit ``get_pk`` and the CLASS
``LinearPower`` on numpy and on a CPU tensor, to 1e-10 relative. Every
set reads its shipped table, so no test here solves."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nbodykit_tpu.cosmology as J
import nbodykit_tpu_torch.cosmology as T

RTOL = 1e-10
SETS = ['Planck13', 'Planck15', 'WMAP5', 'WMAP7', 'WMAP9']
K = np.logspace(-4, 1, 41)


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    from nbodykit_tpu.cosmology import boltzmann as JB
    monkeypatch.setenv('NBKIT_TORCH_CLASS_CACHE', str(tmp_path / 'torch'))
    monkeypatch.setattr(JB, '_CACHE_DIR', str(tmp_path / 'jax'))


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize('name', SETS)
def test_sigma8(name):
    _close(getattr(T, name).sigma8, getattr(J, name).sigma8)
    assert getattr(T, name).engine.source == 'shipped'


def test_sigma8_z_and_sigma_r():
    z = np.array([0.0, 0.55, 2.0])
    _close(T.Planck15.sigma8_z(z), J.Planck15.sigma8_z(z))
    _close(T.Planck15.sigma8_z(1.3), J.Planck15.sigma8_z(1.3))
    _close(T.WMAP9.sigma_r(20.0, 0.7), J.WMAP9.sigma_r(20.0, 0.7))


@pytest.mark.parametrize('name', ['Planck15', 'WMAP7'])
def test_get_pklin(name):
    t, j = getattr(T, name), getattr(J, name)
    z = np.array([0.0, 0.3, 1.7])[:, None]
    _close(t.get_pklin(K, z), j.get_pklin(K, z))
    # the tilted extrapolation below the table, and a scalar
    _close(t.get_pklin(np.array([1e-7, 1e-6]), 0.5),
           j.get_pklin(np.array([1e-7, 1e-6]), 0.5))
    assert t.get_pklin(0.1, 0.0) == j.get_pklin(0.1, 0.0)


@pytest.mark.parametrize('z', [0.0, 0.55, 3.0])
def test_get_transfer(z):
    t = T.Planck15.get_transfer(z)
    j = J.Planck15.get_transfer(z)
    assert sorted(t) == sorted(j)
    for q in j:
        _close(t[q], j[q])


def test_match_sigma8():
    t = T.Planck15.match(sigma8=0.8)
    j = J.Planck15.match(sigma8=0.8)
    _close(t.sigma8, 0.8)
    _close(t.sigma8, j.sigma8)
    _close(t.get_pklin(K, 0.2), j.get_pklin(K, 0.2))
    assert t.engine.source == 'shipped'


def test_get_pk_nonlinear():
    t = T.Planck15.clone(nonlinear=True)
    j = J.Planck15.clone(nonlinear=True)
    k = np.logspace(-3, 0.5, 12)
    _close(t.get_pk(k, 0.55), j.get_pk(k, 0.55))
    kz = (k[:4], np.array([0.0, 0.0, 1.0, 1.0]))
    _close(t.get_pk(*kz), j.get_pk(*kz))
    # linear unless asked
    _close(T.Planck15.get_pk(k, 0.55), T.Planck15.get_pklin(k, 0.55))


def test_linear_power_defaults_to_class():
    t = T.LinearPower(T.Planck15, 0.55)
    j = J.LinearPower(J.Planck15, 0.55)
    assert t.transfer == 'CLASS'
    _close(t.sigma8, j.sigma8)
    assert t.attrs['sigma8'] == j.attrs['sigma8']
    # the CLASS table ends at P_k_max = 10 h/Mpc; beyond it both take
    # the continuity-matched EH transfer
    k = np.concatenate([[0.0], np.logspace(-6, 3, 200), [2e3]])
    _close(t(k), j(k))
    _close(t.sigma_r(8.0), j.sigma_r(8.0))
    _close(t.velocity_dispersion(), j.velocity_dispersion())
    for p in (t, j):
        p.redshift = 1.2
        p.sigma8 = 0.75
    _close(t(k), j(k))


@pytest.mark.parametrize('dtype,rtol', [(np.float64, RTOL),
                                        (np.float32, 1e-6)])
def test_linear_power_class_on_a_tensor(dtype, rtol):
    """The table interpolation on the tensor's device against JAX's
    ``jnp.interp`` branch, over the whole table (1e-6 to 1e3 h/Mpc) and
    past both ends. f32 k takes its log in f32 in both packages, where
    torch's and XLA's logs may differ by an ulp."""
    t = T.LinearPower(T.Planck15, 0.55)
    j = J.LinearPower(J.Planck15, 0.55)
    k = np.concatenate([[0.0, 1e-8], np.logspace(-6, 3, 301), [5e3]])
    k = k.astype(dtype)
    got = t(torch.from_numpy(k))
    ref = np.asarray(j(jnp.asarray(k)))
    assert got.dtype == torch.float64 and got[0] == 0.0
    _close(got.numpy(), ref, rtol)
    # a 3-D k (the shape a mesh hands it)
    k3 = torch.from_numpy(k[1:65].reshape(4, 4, 4))
    _close(t(k3).numpy(), np.asarray(j(jnp.asarray(k[1:65]))).reshape(
        4, 4, 4), rtol)


def test_linear_power_eh_still_needs_no_engine(monkeypatch):
    """The EH path normalises from A_s and never builds the engine."""
    c = T.Planck15.clone(h=0.71)
    monkeypatch.setattr(type(c), 'engine', property(
        lambda self: pytest.fail("the EH path touched the engine")))
    p = T.LinearPower(c, 0.3, 'EisensteinHu')
    j = J.LinearPower(J.Planck15.clone(h=0.71), 0.3, 'EisensteinHu')
    _close(p(K), j(K))
