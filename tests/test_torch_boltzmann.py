"""The port's Einstein-Boltzmann engine against the JAX package's: the
solver's right-hand sides at fixed points, the native solve bit for bit
(both packages build the root ``csrc/boltzmann_kernel.cpp`` with the same
g++ flags), the scipy BDF path to 1e-10, the engine's cache keys and
table lookup, and the failure modes (a failed build or native solve
raises; nothing falls back)."""

import os
import types

import numpy as np
import pytest

from nbodykit_tpu.cosmology import _native as jnative
from nbodykit_tpu.cosmology import boltzmann as JB
import nbodykit_tpu.cosmology as jcosmo
from nbodykit_tpu_torch import _build
from nbodykit_tpu_torch.cosmology import boltzmann as TB
import nbodykit_tpu_torch.cosmology as tcosmo

RTOL = 1e-10
SETS = ['Planck13', 'Planck15', 'WMAP5', 'WMAP7', 'WMAP9']
# the k values of the JAX package's native-kernel test (1/Mpc)
K_NATIVE = [1e-4, 0.05, 0.6]
NU = dict(h=0.67556, T0_cmb=2.7255, Omega_b=0.0482754, Omega_cdm=0.263771,
          m_ncdm=[0.06], N_ur=2.0328)
NONU = dict(h=0.7, T0_cmb=2.725, Omega_b=0.046, Omega_cdm=0.24, m_ncdm=[],
            N_ur=3.046)


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    """Neither package may see tables the other (or an earlier run)
    wrote."""
    monkeypatch.setenv('NBKIT_TORCH_CLASS_CACHE', str(tmp_path / 'torch'))
    monkeypatch.setattr(JB, '_CACHE_DIR', str(tmp_path / 'jax'))


def _solvers(pars, **kw):
    out = []
    for mod in (JB, TB):
        bg = mod.Background(**pars)
        out.append(mod.BoltzmannSolver(bg, mod.Thermodynamics(bg), **kw))
    return out


@pytest.fixture(scope='module', params=['nu', 'nonu'])
def solvers(request):
    return _solvers(NU if request.param == 'nu' else NONU)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


def test_native_inputs_are_identical(solvers):
    """Bit-identity of the native solve needs identical inputs: the
    background tables, the ncdm quadrature and the switch times."""
    j, t = solvers
    for name in ('_g_lnHc', '_g_lntau', '_g_lndk', '_g_cs2', '_q', '_Wq',
                 '_dlnf'):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    for a, b in zip(t._g_ncdm_lndrho + t._g_ncdm_w + t._g_ncdm_cg2,
                    j._g_ncdm_lndrho + j._g_ncdm_w + j._g_ncdm_cg2):
        np.testing.assert_array_equal(a, b)
    assert (t.nvar, t._gx0, t._gdx) == (j.nvar, j._gx0, j._gdx)
    for k in K_NATIVE:
        lna0 = t._lna_start(k)
        assert lna0 == j._lna_start(k)
        assert t._tca_switch_lna(k, lna0) == j._tca_switch_lna(k, lna0)
        assert t._rsa_switch_lna(k, lna0) == j._rsa_switch_lna(k, lna0)


@pytest.mark.parametrize('k', K_NATIVE)
def test_initial_conditions(solvers, k):
    j, t = solvers
    lna0 = j._lna_start(k)
    _close(t._initial(k, lna0), j._initial(k, lna0))


@pytest.mark.parametrize('which', ['full', 'tca', 'rsa'])
@pytest.mark.parametrize('x', [-12.0, -6.5, -0.3])
def test_rhs_at_fixed_points(solvers, which, x):
    j, t = solvers
    nn = len(j.bg.ncdm)
    n = {'full': j.nvar,
         'tca': 6 + (j.lu + 1) + nn * j.nq * (j.ln + 1),
         'rsa': 5 + 3 * nn}[which]
    y = np.random.RandomState(n).normal(size=n) * 1e-2
    for k in (1e-3, 0.2):
        a = getattr(t, '_rhs_' + which)(x, y.copy(), k)
        b = getattr(j, '_rhs_' + which)(x, y.copy(), k)
        _close(a, b)


def _lna_out():
    return np.sort(np.log(1.0 / (1.0 + np.array([9.0, 1.0, 0.0]))))


@pytest.mark.parametrize('k', K_NATIVE)
def test_native_solve_is_bit_identical(solvers, k):
    j, t = solvers
    ref = jnative.solve_mode_native(j, k, _lna_out())
    assert ref is not None, "the JAX package's native kernel did not build"
    got = t.solve_mode(k, _lna_out())
    assert sorted(got) == sorted(ref)
    for q in ref:
        np.testing.assert_array_equal(got[q], ref[q], err_msg=q)


def test_python_path_matches_jax():
    """``use_native=False`` runs the scipy BDF path, equal to the JAX
    package's to 1e-10."""
    j, t = _solvers(NU, use_native=False)
    got = t.solve_mode(0.05, _lna_out())
    ref = j._solve_mode_py(0.05, _lna_out())
    for q in ref:
        _close(got[q], ref[q])


@pytest.mark.parametrize('name', SETS)
def test_engine_key_names_a_shipped_table(name):
    key = getattr(tcosmo, name).engine._key()
    assert key == getattr(jcosmo, name).engine._key()
    assert os.path.exists(os.path.join(TB._DATA_DIR, key + '.npz'))


def test_shipped_tables_are_the_jax_packages():
    jdir = os.path.join(os.path.dirname(JB.__file__), 'data')
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(TB._DATA_DIR)) == names
    for n in names:
        a, b = np.load(os.path.join(jdir, n)), \
            np.load(os.path.join(TB._DATA_DIR, n))
        assert a.files == b.files
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize('name', SETS)
def test_builtin_sets_load_without_a_solve(name, monkeypatch):
    def no_solver(*a, **k):
        raise AssertionError("a built-in set started a solve")
    monkeypatch.setattr(TB, 'BoltzmannSolver', no_solver)
    c = getattr(tcosmo, name).clone()
    assert c.engine._solve_tables()['k'].size > 100
    assert c.engine.source == 'shipped'


def test_key_carries_python_floats():
    """repr() of the key tuple sees every number as JAX does: a numpy
    scalar would print np.float64(...) and miss the shipped table."""
    e = tcosmo.Planck15.engine
    bg, th = e.bg, e.th
    for v in (bg.h, bg.T0_cmb, bg.Omega_b, bg.Omega_cdm, bg.Omega_k,
              bg.Omega_ur, bg.w0_fld, bg.wa_fld, th.YHe, th.z_reio,
              th.reio_width, th.fudge, e.n_s, e.P_k_max, e.P_z_max):
        assert type(v) is float, (v, type(v))
    assert all(type(s.m_ev) is float for s in bg.ncdm)


def test_fresh_solve_writes_and_reads_the_user_cache(tmp_path, monkeypatch):
    """A parameter set with no shipped table is solved (native), written
    to the port's own cache and read back, bit-identical to the JAX
    package's solve on the same short k grid."""
    grid = lambda kmax: np.array([1e-3, 0.02, 0.2])      # noqa: E731
    monkeypatch.setattr(TB, '_default_kgrid', grid)
    monkeypatch.setattr(JB, '_default_kgrid', grid)
    cj = jcosmo.Planck15.clone(h=0.7)
    ct = tcosmo.Planck15.clone(h=0.7)
    ref = cj.engine._solve_tables()
    got = ct.engine._solve_tables()
    assert ct.engine.source == 'solved'
    for q in ref:
        np.testing.assert_array_equal(got[q], ref[q], err_msg=q)
    name = ct.engine._key() + '.npz'
    assert os.listdir(os.environ['NBKIT_TORCH_CLASS_CACHE']) == [name]
    assert os.listdir(str(tmp_path / 'jax')) == [name]
    again = tcosmo.Planck15.clone(h=0.7)
    again.engine._solve_tables()
    assert again.engine.source == 'cache'


@pytest.mark.parametrize('r', [1.0, 8.0, 30.0])
def test_tophat_sigma(r):
    k = np.exp(np.linspace(np.log(1e-4), np.log(10.0), 300))
    pk = 1e4 * k / (1 + (k / 0.02) ** 2.5)
    _close(TB.tophat_sigma(k, pk, r), JB.tophat_sigma(k, pk, r))


def test_default_kgrid():
    for kmax in (0.3, 6.774):
        _close(TB._default_kgrid(kmax), JB._default_kgrid(kmax))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, 'HOST_FLAGS', ['-O3', '-shared', '-fPIC',
                                               '-std=c++17',
                                               '-fno-such-option-nbk'])
    monkeypatch.setattr(_build, '_libs', {})
    with pytest.raises(RuntimeError, match='failed to build'):
        _build.load_host('boltzmann_kernel')
    monkeypatch.setattr(_build, 'gxx', lambda: str(tmp_path / 'no-g++'))
    with pytest.raises(OSError):
        _build.build_all(['boltzmann_kernel'])


def test_failed_native_solve_raises(solvers, monkeypatch):
    failing = types.SimpleNamespace(nbk_solve_mode=lambda *args: -1)
    monkeypatch.setattr(_build, 'load_host', lambda name: failing)
    t = solvers[1]
    with pytest.raises(RuntimeError, match='return code -1'):
        t.solve_mode(0.05, _lna_out())


def test_host_library_is_built_with_the_jax_flags():
    from nbodykit_tpu import _native_build
    import inspect
    src = inspect.getsource(_native_build.build_kernel)
    assert "'-O3', '-shared', '-fPIC', '-std=c++17'" in src
    assert _build.HOST_FLAGS == ['-O3', '-shared', '-fPIC', '-std=c++17']
    src_path, lib = _build._target('boltzmann_kernel')
    assert os.path.samefile(src_path, os.path.join(
        _native_build._CSRC, 'boltzmann_kernel.cpp'))
    assert lib.startswith(_build.BUILD_DIR)


@pytest.mark.slow
def test_fresh_full_solve_sigma8():
    """One fresh solve of the full k grid (~30 s a side)."""
    cj = jcosmo.Planck15.clone(h=0.7)
    ct = tcosmo.Planck15.clone(h=0.7)
    assert ct.sigma8 == cj.sigma8
    np.testing.assert_allclose(ct.sigma8, 0.84576, rtol=1e-5)
