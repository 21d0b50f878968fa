"""The port's nonlinear and derived spectra against the JAX package's
(x64 on, 1e-10 relative): HalofitPower, ZeldovichPower, the FFTLog
transforms, pk_to_xi / xi_to_pk, CorrelationFunction, FNLGalaxyPower and
LinearNbody (on numpy and on a CPU tensor). The CLASS spectra read the
shipped Planck15 table."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nbodykit_tpu.cosmology as J
from nbodykit_tpu.ops import fftlog as jfftlog
import nbodykit_tpu_torch.cosmology as T
from nbodykit_tpu_torch.ops import fftlog as tfftlog

RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=0)


@pytest.fixture(scope='module')
def plin():
    return (T.LinearPower(T.Planck15, 0.55), J.LinearPower(J.Planck15, 0.55))


@pytest.mark.parametrize('z', [0.0, 0.55])
def test_halofit(z):
    k = np.logspace(-3, 1, 25)
    t = T.HalofitPower(T.Planck15, z)
    j = J.HalofitPower(J.Planck15, z)
    _close(t(k), j(k))
    assert t.attrs == j.attrs


def test_halofit_reuses_a_linear_power():
    lt = T.LinearPower(T.WMAP9, 0.0, 'EisensteinHu')
    lj = J.LinearPower(J.WMAP9, 0.0, 'EisensteinHu')
    k = np.logspace(-2, 0.7, 9)
    _close(T.HalofitPower(T.WMAP9, 0.0, linear=lt)(k),
           J.HalofitPower(J.WMAP9, 0.0, linear=lj)(k))


def test_zeldovich():
    k = np.array([0.0, 0.002, 0.05, 0.2, 0.6])
    t = T.ZeldovichPower(T.Planck15, 0.55)
    j = J.ZeldovichPower(J.Planck15, 0.55)
    _close(t(k), j(k))
    _close(t(0.1), j(0.1))
    _close(t.sigma8, j.sigma8)


@pytest.mark.parametrize('ell', [0, 2, 4])
def test_fftlog_transforms(ell):
    k = np.logspace(-4, 2, 512)
    pk = 1e4 * k / (1 + (k / 0.02) ** 3)
    for tf, jf in ((tfftlog.pk_to_xi_fftlog, jfftlog.pk_to_xi_fftlog),
                   (tfftlog.xi_to_pk_fftlog, jfftlog.xi_to_pk_fftlog)):
        (a, b), (c, d) = tf(k, pk, ell=ell), jf(k, pk, ell=ell)
        _close(a, c)
        np.testing.assert_allclose(b, d, rtol=RTOL,
                                   atol=1e-13 * np.abs(d).max())


def test_pk_to_xi_and_back(plin):
    k = np.logspace(-4, 1.5, 1024)
    r = np.linspace(5.0, 180.0, 36)
    xt = T.pk_to_xi(k, plin[0](k))
    xj = J.pk_to_xi(k, plin[1](k))
    _close(xt(r), xj(r))
    _close(T.pk_to_xi(k, plin[0](k), ell=2, extrap=False)(r),
           J.pk_to_xi(k, plin[1](k), ell=2, extrap=False)(r))
    rr = np.logspace(-2, 3.5, 1024)
    kk = np.logspace(-2, 0, 20)
    for extrap in (False, True):
        _close(T.xi_to_pk(rr, xt(rr), extrap=extrap)(kk),
               J.xi_to_pk(rr, xj(rr), extrap=extrap)(kk))


def test_correlation_function(plin):
    r = np.linspace(10.0, 150.0, 29)
    t = T.CorrelationFunction(plin[0])
    j = J.CorrelationFunction(plin[1])
    _close(t(r), j(r))
    assert t.redshift == j.redshift == 0.55
    _close(T.CorrelationFunction(T.HalofitPower(T.Planck15, 0.0))(r),
           J.CorrelationFunction(J.HalofitPower(J.Planck15, 0.0))(r))


@pytest.mark.parametrize('transfer', ['CLASS', 'EisensteinHu'])
@pytest.mark.parametrize('fnl,p', [(0.0, 1.0), (10.0, 1.0), (-25.0, 1.6)])
def test_fnl_galaxy_power(transfer, fnl, p):
    k = np.logspace(-4, 0, 30)
    t = T.FNLGalaxyPower(T.Planck15, 0.55, b1=2.0, fnl=fnl, p=p,
                         transfer=transfer)
    j = J.FNLGalaxyPower(J.Planck15, 0.55, b1=2.0, fnl=fnl, p=p,
                         transfer=transfer)
    _close(t(k), j(k))
    _close(t.bias_k(k), j.bias_k(k))
    _close(t.sigma8, j.sigma8)
    assert t.attrs == j.attrs


def test_linear_nbody():
    rs = np.random.RandomState(4)
    q = rs.uniform(0, 100, (500, 3))
    disp = rs.normal(size=(500, 3))
    vel = rs.normal(size=(500, 3)) * 100
    j = J.LinearNbody(J.Planck15).integrate(
        jnp.asarray(q), jnp.asarray(disp), jnp.asarray(vel), 0.1, 0.7)
    t = T.LinearNbody(T.Planck15)
    got = t.integrate(torch.from_numpy(q), torch.from_numpy(disp),
                      torch.from_numpy(vel), 0.1, 0.7)
    for a, b in zip(got, j):
        assert isinstance(a, torch.Tensor) and a.device.type == 'cpu'
        _close(a.numpy(), np.asarray(b))
    onnp = t.integrate(q, disp, vel, 0.1, 0.7)
    for a, b in zip(onnp, j):
        _close(a, np.asarray(b))
