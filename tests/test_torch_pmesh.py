"""ParticleMesh of the PyTorch port against the JAX package: the r2c/c2r
transposed layout and values on a non-cubic mesh, the coordinate
arrays, and paint through the option plumbing."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.pmesh import ParticleMesh as JaxPM
from nbodykit_tpu.utils import as_numpy
from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_plain
from nbodykit_tpu_torch.pmesh import ParticleMesh

NMESH = (16, 12, 10)
BOX = (100.0, 80.0, 60.0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def _pms(dtype='f8'):
    return JaxPM(NMESH, BOX, dtype=dtype), ParticleMesh(NMESH, BOX,
                                                        dtype=dtype)


@pytest.mark.parametrize('dtype,rtol', [('f8', 1e-12), ('f4', 1e-5)])
def test_r2c_c2r_layout_and_values(dtype, rtol):
    jpm, tpm = _pms(dtype)
    x = np.random.RandomState(0).normal(size=NMESH).astype(dtype)
    cj = as_numpy(jpm.r2c(jnp.asarray(x)))
    ct = tpm.r2c(torch.as_tensor(x))
    assert tuple(ct.shape) == tpm.shape_complex == jpm.shape_complex \
        == (12, 16, 6)
    assert ct.dtype == (torch.complex128 if dtype == 'f8'
                        else torch.complex64)
    scale = np.abs(cj).max()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=rtol * scale)
    back = tpm.c2r(ct)
    assert back.dtype == tpm.torch_dtype
    np.testing.assert_allclose(back.numpy(), x, rtol=0,
                               atol=rtol * np.abs(x).max())
    jback = np.asarray(jpm.c2r(jnp.asarray(cj)))
    np.testing.assert_allclose(tpm.c2r(torch.as_tensor(cj)).numpy(), jback,
                               rtol=0, atol=rtol * np.abs(x).max())


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_coordinate_arrays_equal(dtype):
    jpm, tpm = _pms(dtype)
    for kw in (dict(), dict(circular=True), dict(full=True),
               dict(dtype='f8')):
        for a, b in zip(tpm.k_list(**kw), jpm.k_list(**kw)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tpm.i_list_complex(), jpm.i_list_complex()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tpm.x_list(), jpm.x_list()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    np.testing.assert_array_equal(tpm.hermitian_weights().numpy(),
                                  np.asarray(jpm.hermitian_weights()))
    for N in (7, 10):
        w_t = ParticleMesh(N, 1.0).hermitian_weights(dtype='f8')
        w_j = JaxPM(N, 1.0, dtype='f8').hermitian_weights(
            dtype=jnp.float64)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize('method,order', [('mxu', 'radix'),
                                          ('mxu', 'argsort'),
                                          ('scatter', 'auto')])
def test_paint_option_plumbing_conserves_mass(method, order, monkeypatch):
    calls = []
    import nbodykit_tpu_torch.ops.paint as tpaint

    def spy(*a, **kw):
        calls.append(1)
        return deposit_blocks_plain(*a, **kw)

    monkeypatch.setattr(tpaint, 'deposit_blocks',
                        lambda *a, ck, **kw: spy(*a, ck=ck, **kw))
    pm = ParticleMesh(32, 100.0, dtype='f8')
    rng = np.random.RandomState(5)
    pos = rng.uniform(0, 100.0, (5000, 3))
    mass = rng.uniform(0.5, 1.5, 5000)
    with nbodykit_tpu_torch.set_options(paint_method=method,
                                        paint_order=order,
                                        paint_bucket_slack=0.3):
        field = pm.paint(torch.as_tensor(pos), torch.as_tensor(mass))
    assert field.dtype == torch.float64
    assert abs(float(field.sum()) - mass.sum()) < 1e-9 * mass.sum()
    # the mxu path really ran the deposit (and its overflow backoff
    # ended with nothing dropped: the mass is all there)
    assert bool(calls) == (method == 'mxu')
    jpm = JaxPM(32, 100.0, dtype='f8')
    ref = np.asarray(jpm.paint(jnp.asarray(pos), jnp.asarray(mass)))
    np.testing.assert_allclose(field.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_readout_matches_jax():
    jpm, tpm = _pms('f8')
    rng = np.random.RandomState(6)
    field = rng.normal(size=NMESH)
    pos = rng.uniform(0, 1, (1000, 3)) * np.asarray(BOX)
    ref = np.asarray(jpm.readout(jnp.asarray(field), jnp.asarray(pos),
                                 resampler='tsc'))
    got = tpm.readout(torch.as_tensor(field), torch.as_tensor(pos),
                      resampler='tsc')
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-13)


def test_paint_rejects_positions_on_another_device():
    pm = ParticleMesh(8, 1.0)
    with pytest.raises(ValueError):
        pm.paint(torch.zeros((2, 3), device='meta'))
