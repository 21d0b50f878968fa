"""The bispectrum through the PyTorch port and the JAX package on the
same seeded numpy inputs: the enumerations bit for bit, the pairblock
sum, the FFT and direct estimators at f8 (and the FFT one at f4) on the
JAX package's oracle cases, and ``Bispectrum`` end to end through
``UniformCatalog`` with its ``auto`` resolution, validation and state.
The two multi-device JAX tests are not used (they fail on the JAX side,
ROADMAP Queue C)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nbodykit_tpu
import nbodykit_tpu_torch
from nbodykit_tpu.algorithms import bispectrum as jb
from nbodykit_tpu.algorithms.bispectrum import Bispectrum as JBispectrum
from nbodykit_tpu.ops import pairblock as jpb
from nbodykit_tpu.pmesh import ParticleMesh as JPM
from nbodykit_tpu.source.catalog.uniform import UniformCatalog as JUniform
from nbodykit_tpu.tune import reset_cache_memo
from nbodykit_tpu.tune.resolve import resolve_bispectrum
from nbodykit_tpu_torch import convert
from nbodykit_tpu_torch.algorithms import bispectrum as tb
from nbodykit_tpu_torch.lab import Bispectrum, UniformCatalog
from nbodykit_tpu_torch.ops import pairblock as tpb
from nbodykit_tpu_torch.pmesh import ParticleMesh as TPM


@pytest.fixture(autouse=True)
def _on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def same_nan(a, b):
    return np.array_equal(np.nan_to_num(a, nan=-1.0),
                          np.nan_to_num(b, nan=-1.0))


@pytest.mark.parametrize('nbins', [1, 2, 3, 5, 8])
def test_enumerations_bit_for_bit(nbins):
    assert tb.triangle_bins(nbins) == jb.triangle_bins(nbins)
    q, sh = tb.shell_modes(nbins)
    jq, jsh = jb.shell_modes(nbins)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(sh, jsh)
    for box in (100.0, [100.0, 80.0, 120.0]):
        np.testing.assert_array_equal(tpb.lattice_kvecs(q, box),
                                      jpb.lattice_kvecs(jq, box))
        e, k = tb._shell_edges2(nbins, np.ones(3) * box)
        je, jk = jb._shell_edges2(nbins, np.ones(3) * box)
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(k, jk)


@pytest.mark.parametrize('tile,block', [(64, None), (None, None),
                                        (16, 4096)])
def test_pairblock_sum_matches_jax(tile, block, monkeypatch):
    """Within 1e-12 of sum |w_j|, against the JAX package's single-device
    sum and the numpy sum; ragged sizes pad with zero weights, and a
    small block budget takes many blocks on both axes."""
    if block is not None:
        monkeypatch.setattr(tpb, 'BLOCK_ELEMENTS', block)
    rng = np.random.RandomState(11)
    pos = rng.uniform(0, 100.0, (300, 3))
    w = rng.uniform(0.5, 1.5, 300)
    q, _ = jb.shell_modes(2)
    kv = jpb.lattice_kvecs(q, 100.0)
    want = (w[None, :] * np.exp(-1j * (kv @ pos.T))).sum(axis=1)
    jgot = np.asarray(jpb.pairblock_sum(jnp.asarray(pos), jnp.asarray(w),
                                        kv, tile=tile or 1024))
    got = tpb.pairblock_sum(torch.as_tensor(pos), torch.as_tensor(w), kv,
                            tile=tile)
    assert got.dtype == torch.complex128 and got.shape == (len(kv),)
    bar = 1e-12 * np.abs(w).sum()
    assert np.abs(got.numpy() - jgot).max() <= bar
    assert np.abs(got.numpy() - want).max() <= bar


def _oracle_field(dtype):
    N, L = 16, 100.0
    real = np.random.RandomState(42).standard_normal((N, N, N))
    return N, L, real.astype(dtype)


@pytest.mark.parametrize('dtype', ['f8', 'f4'])
def test_fft_bispectrum_matches_jax(dtype):
    """The all-triangle oracle case: f8 to 1e-10 relative, f4 to 1e-4 of
    the largest |B|; ntri bit for bit at both."""
    N, L, real = _oracle_field(dtype)
    jpm = JPM(Nmesh=N, BoxSize=L, dtype=dtype)
    jB, jn = jb.fft_bispectrum(jpm, jpm.r2c(jnp.asarray(real)), 4)
    tpm = TPM(N, L, dtype=dtype, device='cpu')
    B, n = tb.fft_bispectrum(tpm, tpm.r2c(torch.as_tensor(real)), 4)
    assert same_nan(n, jn) and np.array_equal(np.isnan(B), np.isnan(jB))
    m = ~np.isnan(jB)
    assert m.sum() > 20
    if dtype == 'f8':
        np.testing.assert_allclose(B[m], jB[m], rtol=1e-10, atol=0)
    else:
        assert np.abs(B[m] - jB[m]).max() <= 1e-4 * np.abs(jB[m]).max()


def test_direct_bispectrum_matches_jax():
    """The true-closure oracle case (400 particles, nbins 3, tile 128)."""
    rng = np.random.RandomState(7)
    Np, L, nbins = 400, 100.0, 3
    pos = rng.uniform(0, L, (Np, 3))
    w = rng.uniform(0.5, 1.5, Np)
    jB, jn = jb.direct_bispectrum(jnp.asarray(pos), jnp.asarray(w), L,
                                  nbins, tile=128)
    B, n = tb.direct_bispectrum(torch.as_tensor(pos), torch.as_tensor(w),
                                L, nbins, tile=128)
    assert same_nan(n, jn) and np.array_equal(np.isnan(B), np.isnan(jB))
    m = ~np.isnan(jB)
    np.testing.assert_allclose(B[m], jB[m], rtol=1e-10, atol=0)


def _signal(cat, L=100.0):
    """The JAX test's imprinted non-Gaussian weights (numpy, seed 3)."""
    pos = np.asarray(cat['Position'].cpu() if isinstance(
        cat['Position'], torch.Tensor) else cat['Position'])
    rng = np.random.RandomState(3)
    g = np.zeros(len(pos))
    for m in [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1),
              (1, 0, 1), (2, 0, 0), (1, 1, 1)]:
        ph = rng.uniform(0, 2 * np.pi)
        g += 0.4 * np.cos(2 * np.pi * (pos @ np.array(m)) / L + ph)
    cat['Weight'] = (1.0 + 0.5 * g) ** 2
    return cat


@pytest.fixture(scope='module')
def results():
    """Both packages' Bispectrum on the seeded signal catalog, FFT at
    Nmesh 16 and direct, nbins 3."""
    jcat = _signal(JUniform(nbar=1e-2, BoxSize=100.0, seed=42))
    with nbodykit_tpu_torch.set_options(device='cpu'):
        cat = _signal(UniformCatalog(nbar=1e-2, BoxSize=100.0, seed=42))
        out = {m: Bispectrum(cat, nbins=3, Nmesh=16, method=m, tile=256)
               for m in ('fft', 'direct')}
    jout = {m: JBispectrum(jcat, nbins=3, Nmesh=16, method=m, tile=256)
            for m in ('fft', 'direct')}
    return cat, out, jout


@pytest.mark.parametrize('method', ['fft', 'direct'])
def test_bispectrum_end_to_end_matches_jax(results, method):
    cat, out, jout = results
    r, jr = out[method], jout[method]
    assert r.attrs['method'] == jr.attrs['method'] == method
    assert same_nan(r.B['ntri'], jr.B['ntri'])
    m = ~np.isnan(jr.B['B'])
    np.testing.assert_allclose(r.B['B'][m], jr.B['B'][m], rtol=1e-10)
    for key in ('nbins', 'kf', 'volume'):
        assert r.attrs[key] == pytest.approx(jr.attrs[key], rel=1e-15)
    for k in ('k1', 'k2', 'k3'):
        np.testing.assert_array_equal(r.B[k], jr.B[k])
    np.testing.assert_array_equal(r.B.edges['k1'], jr.B.edges['k1'])
    # the JAX result's state carried across
    x = convert.bispectrum_from_state(jr.__getstate__())
    assert same_nan(x.B['B'], jr.B['B'])
    assert x.attrs['method'] == method


def test_fft_and_direct_agree_alias_free(results):
    """2 (nbins + 1) = 8 <= Nmesh/2: the mod-N and the true closures
    coincide, so the counts are identical and B agrees to the JAX
    test's bar."""
    _, out, _ = results
    Bf, Bd = out['fft'].B['B'], out['direct'].B['B']
    assert same_nan(out['fft'].B['ntri'], out['direct'].B['ntri'])
    m = ~np.isnan(Bf)
    scale = np.abs(Bd[m]).max()
    assert np.allclose(Bf[m], Bd[m], rtol=2e-2, atol=2e-2 * scale)


def test_bispectrum_state_round_trip(results, tmp_path):
    _, out, _ = results
    a = out['fft']
    path = str(tmp_path / 'bspec.json')
    a.save(path)
    c = Bispectrum.load(path)
    assert same_nan(c.B['B'], a.B['B'])
    assert c.attrs['nbins'] == 3 and c.attrs['method'] == 'fft'


def test_bispectrum_auto_and_validation(tmp_path):
    """'auto' and tile=None resolve as the JAX tuner's cold cache does;
    the same ValueErrors as JAX."""
    saved = dict(nbodykit_tpu._global_options)
    try:
        nbodykit_tpu.set_options(tune_cache=str(tmp_path / 'ABSENT.json'))
        reset_cache_memo()
        cfg = resolve_bispectrum(nmesh=16, npart=1000, nproc=1)
        jcat = JUniform(nbar=2e-3, BoxSize=100.0, seed=1)
        jauto = JBispectrum(jcat.to_mesh(Nmesh=16), nbins=2)
    finally:
        nbodykit_tpu._global_options.clear()
        nbodykit_tpu._global_options.update(saved)
        reset_cache_memo()
    assert (cfg['bspec_method'], cfg['pairblock_tile']) == \
        ('fft', tpb.DEFAULT_TILE)
    cat = UniformCatalog(nbar=2e-3, BoxSize=100.0, seed=1)
    mesh = cat.to_mesh(Nmesh=16)
    auto = Bispectrum(mesh, nbins=2)
    assert auto.attrs['method'] == jauto.attrs['method'] == 'fft'
    assert same_nan(auto.B['ntri'], jauto.B['ntri'])
    m = ~np.isnan(jauto.B['B'])
    np.testing.assert_allclose(auto.B['B'][m], jauto.B['B'][m], rtol=1e-4)
    assert Bispectrum(cat, nbins=2, Nmesh=16).attrs['method'] == 'fft'
    for kwargs in (dict(nbins=0, Nmesh=16), dict(nbins=2, Nmesh=16,
                                                 method='exact')):
        for make, src in ((Bispectrum, cat), (JBispectrum, jcat)):
            with pytest.raises(ValueError):
                make(src, **kwargs)
    for make, src in ((Bispectrum, mesh), (JBispectrum,
                                           jcat.to_mesh(Nmesh=16))):
        with pytest.raises(ValueError, match='catalog source'):
            make(src, nbins=2, method='direct')
