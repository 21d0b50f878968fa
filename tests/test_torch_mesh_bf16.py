"""bf16 mesh storage in the PyTorch port against the JAX package's
contracts (``tests/test_precision.py``), on the same seeded inputs:

- a ``ParticleMesh(..., dtype='bf16')`` paints bfloat16 (bit for bit
  the JAX field), reads out f4, transforms to complex64 and back to
  bfloat16; coordinates stay f4;
- mass is conserved within 5e-3 by every paint family;
- the narrow streams paint (bf16 replicas, two-sum split) equals JAX's
  within one bf16 rounding of the largest cell (measured: equal);
- FFTPower under ``set_options(mesh_dtype='bf16')`` at 64^3 / 2e4
  particles has the full-width run's mode counts and is within 2e-2 of
  it up to k_Nyquist/2 (the JAX budget), and within 2e-2 of JAX's bf16
  run;
- ``convert`` carries a JAX bf16 array across bit for bit, a saved
  bf16 field is the JAX package's bytes, and ``BigFileMesh`` reloads
  it.

The port divides the painted bf16 field by the mean density at f32
(torch's op math); JAX rounds the Python scalar to bf16 first, so the
normalised fields differ by up to one bf16 rounding (ROADMAP Queue C).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu
import nbodykit_tpu_torch
from nbodykit_tpu.base.mesh import Field as JField, FieldMesh as JFieldMesh
from nbodykit_tpu.lab import ArrayCatalog as JArrayCatalog
from nbodykit_tpu.lab import FFTPower as JFFTPower
from nbodykit_tpu.ops import paint as jpaint
from nbodykit_tpu.pmesh import ParticleMesh as JPM
from nbodykit_tpu_torch import convert
from nbodykit_tpu_torch.base.mesh import Field, FieldMesh
from nbodykit_tpu_torch.lab import ArrayCatalog, BigFileMesh, FFTPower
from nbodykit_tpu_torch.ops import paint as tpaint
from nbodykit_tpu_torch.pmesh import ParticleMesh

# one bfloat16 rounding, relative (8 significant bits)
BF16_EPS = 2.0 ** -8
MASS_RTOL = 5e-3
PK_BUDGET = 2e-2
# tests/test_precision.py's FFTPower case
NMESH, NPART, BOX, SEED = 64, 20_000, 200.0, 42
KMIN = 0.31 * (2 * np.pi / BOX)
DK = 2.6718 * (2 * np.pi / BOX)
K_NYQ = np.pi * NMESH / BOX


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_bf16_mesh_stores_narrow_and_computes_f32():
    pm = ParticleMesh(16, 32.0, dtype='bf16', device='cpu')
    jpm = JPM(16, 32.0, dtype='bf16')
    assert pm.dtype is torch.bfloat16 and pm.torch_dtype is torch.bfloat16
    assert pm.compute_dtype == np.dtype('f4') == jpm.compute_dtype
    assert pm.torch_compute_dtype is torch.float32
    pos = np.random.RandomState(0).uniform(0, 32.0, (100, 3))
    field = pm.paint(torch.as_tensor(pos))
    assert field.dtype is torch.bfloat16
    np.testing.assert_array_equal(_bits(field), _bits(jpm.paint(pos)))
    vals = pm.readout(field, torch.as_tensor(pos))
    assert vals.dtype is torch.float32
    cplx = pm.r2c(field)
    assert cplx.dtype is torch.complex64
    assert pm.c2r(cplx).dtype is torch.bfloat16
    assert all(x.dtype is torch.float32 for x in pm.x_list())
    assert all(k.dtype is torch.float32 for k in pm.k_list())
    # the host copy of a bf16 field is float32, value for value
    host = Field(field, pm).numpy()
    assert host.dtype == np.float32
    np.testing.assert_array_equal(host, field.float().numpy())
    with pytest.raises(ValueError, match="'f4', 'f8' or 'bf16'"):
        ParticleMesh(16, 32.0, dtype='f2', device='cpu')


@pytest.mark.parametrize('method', ['scatter', 'sort', 'segsum', 'streams'])
def test_bf16_paint_conserves_mass(method):
    """tests/test_precision.py::test_bf16_paint_conserves_mass for each
    family: within 5e-3 of the particle count."""
    pm = ParticleMesh(32, 64.0, dtype='bf16', device='cpu')
    pos = torch.as_tensor(np.random.RandomState(1).uniform(0, 64.0,
                                                           (5000, 3)))
    with nbodykit_tpu_torch.set_options(paint_method=method):
        field = pm.paint(pos)
    assert field.dtype is torch.bfloat16
    total = float(field.double().sum())
    assert abs(total - 5000.0) / 5000.0 < MASS_RTOL, total


@pytest.mark.parametrize('resampler', ['cic', 'tsc'])
def test_narrow_streams_match_jax(resampler):
    """The bf16-replica streams paint against JAX's, k in {1, 2, 4},
    within one bf16 rounding of the largest cell; its f32 result is
    within 2e-2 of the f8 scatter paint (k = 1 has no compensation)."""
    rng = np.random.default_rng(5)
    shape = (16, 16, 16)
    pos = rng.uniform(0, 16, (3000, 3))
    mass = rng.uniform(0.5, 2.0, 3000)
    ref8 = tpaint.paint_local(torch.as_tensor(pos), torch.as_tensor(mass),
                              shape, resampler=resampler).numpy()
    for k in (1, 2, 4):
        ref = np.asarray(jpaint.paint_local_streams(
            jnp.asarray(pos), jnp.asarray(mass, jnp.float32), shape,
            resampler=resampler, streams=k, storage_dtype=jnp.bfloat16))
        got = tpaint.paint_local_streams(
            torch.as_tensor(pos), torch.as_tensor(mass, dtype=torch.float32),
            shape, resampler=resampler, streams=k, storage_dtype='bf16')
        assert got.dtype is torch.float32 and ref.dtype == np.float32
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=BF16_EPS * scale)
        assert np.abs(got.numpy() - ref8).max() < PK_BUDGET * scale


def _pk(run):
    r = run()
    return (np.asarray(r.power['k'], 'f8'),
            np.asarray(r.power['power'].real, 'f8'),
            np.asarray(r.power['modes'], 'f8'))


def test_fftpower_bf16_within_budget():
    """The mesh-bf16 posture of tests/test_precision.py single-device:
    identical modes, scale-relative error < 2e-2 up to k_Nyquist/2,
    against the port's full-width run and against JAX's bf16 run."""
    pos = np.random.RandomState(SEED).uniform(0.0, BOX, size=(NPART, 3))

    def port(dtype):
        with nbodykit_tpu_torch.set_options(mesh_dtype=dtype):
            cat = ArrayCatalog({'Position': pos}, BoxSize=BOX)
            return FFTPower(cat, mode='1d', Nmesh=NMESH, kmin=KMIN, dk=DK)

    def jax_bf16():
        with nbodykit_tpu.set_options(mesh_dtype='bf16'):
            cat = JArrayCatalog({'Position': pos}, BoxSize=BOX)
            return JFFTPower(cat, mode='1d', Nmesh=NMESH, kmin=KMIN, dk=DK)

    k0, p0, m0 = _pk(lambda: port('f4'))
    sel = (m0 > 0) & np.isfinite(p0) & (k0 <= 0.5 * K_NYQ)
    assert sel.sum() >= 5
    scale = np.abs(p0[sel]).mean()
    errs = {}
    for name, run in (('port', lambda: port('bf16')), ('jax', jax_bf16)):
        k, p, m = _pk(run)
        np.testing.assert_array_equal(m, m0, err_msg=name)
        errs[name] = float((np.abs(p[sel] - p0[sel]) / scale).max())
        assert errs[name] < PK_BUDGET, errs
    # the port's bf16 run against JAX's: both within the budget of the
    # oracle, apart by the normalisation's rounding
    assert errs['port'] > 0


def test_interlaced_compensated_bf16_mesh_as_jax():
    """A bf16 CatalogMesh, interlaced and compensated, through compute
    (both modes) and preview against the JAX package's, within two bf16
    roundings (the normalisation, module docstring)."""
    pos = np.random.RandomState(3).uniform(0, 50.0, (4000, 3))
    kw = dict(Nmesh=16, dtype='bf16', interlaced=True, compensated=True,
              resampler='tsc')
    tm = ArrayCatalog({'Position': pos}, BoxSize=50.0).to_mesh(**kw)
    jm = JArrayCatalog({'Position': pos}, BoxSize=50.0).to_mesh(**kw)
    real = tm.compute(mode='real').value
    assert real.dtype is torch.bfloat16
    jreal = np.asarray(jm.compute(mode='real').value).astype('f4')
    np.testing.assert_allclose(real.float().numpy(), jreal, rtol=0,
                               atol=2 * BF16_EPS * np.abs(jreal).max())
    cplx = tm.compute(mode='complex').value
    assert cplx.dtype is torch.complex64
    prev = tm.preview(axes=(0, 1))
    jprev = np.asarray(jm.preview(axes=(0, 1))).astype('f4')
    assert prev.dtype == np.float32 and prev.shape == jprev.shape
    np.testing.assert_allclose(prev, jprev, rtol=4 * BF16_EPS)
    # the mesh_dtype option is to_mesh's default, as in the JAX package
    cat = ArrayCatalog({'Position': pos}, BoxSize=50.0)
    with nbodykit_tpu_torch.set_options(mesh_dtype='bf16'):
        assert cat.to_mesh(Nmesh=8).pm.dtype is torch.bfloat16
    with nbodykit_tpu_torch.set_options(mesh_dtype='auto'):
        assert cat.to_mesh(Nmesh=8).pm.dtype == np.dtype('f4')
    assert cat.to_mesh(Nmesh=8, dtype='f8').pm.dtype == np.dtype('f8')


def test_convert_save_and_reload_bf16_bit_for_bit(tmp_path):
    """A JAX bf16 field crosses with ``convert`` bit for bit; saving it
    writes the JAX package's bytes (DTYPE '<V2', the raw patterns, the
    same checksum and attrs); ``BigFileMesh`` reloads it as bf16."""
    pos = np.random.RandomState(4).uniform(0, 32.0, (500, 3))
    jpm = JPM(8, 32.0, dtype='bf16')
    jfield = np.asarray(jpm.paint(pos))
    assert jfield.dtype.name == 'bfloat16'
    pm = ParticleMesh(8, 32.0, dtype='bf16', device='cpu')
    field = convert.field_from_numpy(jfield, pm)
    assert field.value.dtype is torch.bfloat16
    np.testing.assert_array_equal(_bits(field.value), _bits(jfield))
    assert convert.tensor_from_numpy(jfield).dtype is torch.bfloat16

    tdir, jdir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    FieldMesh(field).save(tdir)
    JFieldMesh(JField(jnp.asarray(jfield), jpm, 'real')).save(jdir)
    for name in ('header', 'attr-v2', '000000'):
        with open(os.path.join(tdir, 'Field', name), 'rb') as f:
            got = f.read()
        with open(os.path.join(jdir, 'Field', name), 'rb') as f:
            assert got == f.read(), name
    back = BigFileMesh(tdir, 'Field')
    assert back.pm.dtype is torch.bfloat16
    np.testing.assert_array_equal(_bits(back.compute().value),
                                  _bits(jfield))
