"""The port's threefry draws against JAX's, bit for bit (x64 on, as
``tests/conftest.py`` sets it).

Each primitive is checked on its own against ``jax._src.prng`` /
``jax.random`` before the samplers that compose them. Normals use XLA's
``erf_inv`` arithmetic but torch's ``log1p``, so they are held to a
tolerance: 1e-5 relative at f4, 1e-14 absolute at f8.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from jax._src import prng

import nbodykit_tpu_torch
from nbodykit_tpu.rng import DistributedRNG as JaxRNG
from nbodykit_tpu_torch import rng
from nbodykit_tpu_torch.convert import key_from_numpy
from nbodykit_tpu_torch.ops import threefry_cuda as tf
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _on_cpu():
    with nbodykit_tpu_torch.set_options(device='cpu'):
        yield


def jkey(seed):
    return jax.random.key(seed)


def raw(k):
    return np.asarray(jax.random.key_data(k))


SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32, 2 ** 32 + 7, 2 ** 40 + 12345,
         2 ** 63 - 1]


@pytest.mark.parametrize('seed', SEEDS)
def test_threefry_seed(seed):
    np.testing.assert_array_equal(rng.key(seed), raw(jkey(seed)))
    np.testing.assert_array_equal(
        rng.key(seed), np.asarray(prng.threefry_seed(np.int64(seed))))


@pytest.mark.parametrize('n', [1, 2, 3, 4, 7, 10, 1001])
def test_threefry_2x32_odd_and_even(n):
    key = raw(jkey(42))
    count = np.random.RandomState(n).randint(
        0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(prng.threefry_2x32(jnp.asarray(key),
                                        jnp.asarray(count)))
    np.testing.assert_array_equal(rng.threefry_2x32(key, count), ref)


@pytest.mark.parametrize('seed', [0, 42, 2 ** 31 - 1])
@pytest.mark.parametrize('data', [0, 1, 17, 2 ** 31, 2 ** 32 - 1])
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        rng.fold_in(rng.key(seed), data),
        raw(jax.random.fold_in(jkey(seed), data)))


@pytest.mark.parametrize('num', [2, 3, 5])
def test_split(num):
    k = jax.random.fold_in(jkey(7), 3)
    np.testing.assert_array_equal(rng.split(raw(k), num),
                                  raw(jax.random.split(k, num)))


@pytest.mark.parametrize('shape', [(1,), (2,), (3,), (1023,), (4, 5, 6),
                                   (3, 1, 7)])
@pytest.mark.parametrize('width', [32, 64])
def test_random_bits(shape, width):
    k = jkey(42)
    ref = np.asarray(jax.random.bits(
        k, shape, dtype=jnp.uint32 if width == 32 else jnp.uint64))
    got = rng.random_bits(raw(k), width, shape).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_counters_past_two_to_the_32():
    """64-bit counters with a hi word != 0, against JAX's hash
    primitive on the same (hi, lo) words."""
    key = raw(jkey(5))
    c0 = 2 ** 32 - 5
    c = np.arange(c0, c0 + 11, dtype=np.uint64)
    hi = jnp.asarray((c >> 32).astype(np.uint32))
    lo = jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32))
    b1, b2 = prng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                      hi, lo)
    b1, b2 = np.asarray(b1), np.asarray(b2)
    np.testing.assert_array_equal(
        tf.threefry_fill_plain(key, c0, 11, 'bits32').numpy(), b1 ^ b2)
    np.testing.assert_array_equal(
        tf.threefry_fill_plain(key, c0, 11, 'bits64').numpy(),
        (b1.astype(np.uint64) << np.uint64(32)) | b2)


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
@pytest.mark.parametrize('lo,hi', [(0.0, 1.0), (-3.3, 7.1), (2.5, 1000.0),
                                   (1e10, 1e10 + 3)])
def test_uniform(dtype, lo, hi):
    k = jkey(11)
    ref = np.asarray(jax.random.uniform(k, (4, 1000), dtype=dtype,
                                        minval=lo, maxval=hi))
    got = rng.uniform(raw(k), (4, 1000), dtype, lo, hi).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_normal(dtype):
    k = jkey(3)
    ref = np.asarray(jax.random.normal(k, (50, 1000), dtype=dtype))
    got = rng.normal(raw(k), (50, 1000), dtype).numpy()
    assert got.dtype == ref.dtype
    if dtype == 'f4':
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)
    # the tails reach the erf_inv branches past w >= 5 (f4) / 6.25 (f8)
    assert np.abs(ref).max() > 4


def poisson_lams(dtype):
    rs = np.random.RandomState(0)
    lam = np.concatenate([
        np.zeros(50), rs.uniform(0, 10, 3000), rs.uniform(9.5, 10.5, 1000),
        np.full(200, 1e3), [np.nan, 1e-7, 9.999999, 10.0]])
    return lam.astype(dtype)


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_poisson_given_lam(dtype):
    """Counts equal JAX's given the same lam, in every branch: 0, Knuth
    (0 < lam < 10, NaN -> -1), both sides of the switch at 10, and the
    rejection sampler at 1e3."""
    lam = poisson_lams(dtype)
    k = jkey(7)
    ref = np.asarray(jax.random.poisson(k, jnp.asarray(lam)))
    stats = {}
    got = tf.poisson_threefry_plain(raw(k), torch.from_numpy(lam),
                                    stats=stats).numpy()
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert got[np.isnan(lam)][0] == -1 and (got[lam == 0] == 0).all()
    assert stats['hashes'] > lam.size


def test_poisson_shape_and_knuth_only():
    """A 3-D field of small lam (the lognormal path's case: Knuth only,
    the rejection loop is skipped) keeps its shape and JAX's counts."""
    lam = np.random.RandomState(1).lognormal(-3, 1.0, (6, 7, 8))
    k = jax.random.split(jkey(42))[0]
    ref = np.asarray(jax.random.poisson(k, jnp.asarray(lam)))
    got = rng.poisson(raw(k), torch.from_numpy(lam), device='cpu').numpy()
    assert got.shape == lam.shape
    np.testing.assert_array_equal(got, ref)


def test_poisson_table_exhausted_raises(monkeypatch):
    lam = torch.full((100,), 9.0)
    with monkeypatch.context() as m:
        m.setattr(tf, 'KNUTH_TABLE', 3)
        with pytest.raises(tf.PoissonTableExhausted):
            tf.poisson_threefry_plain(rng.key(1), lam)
    lam = torch.full((100,), 1e3)
    with monkeypatch.context() as m:
        m.setattr(tf, 'REJECTION_TABLE', 0)
        with pytest.raises(tf.PoissonTableExhausted):
            tf.poisson_threefry_plain(rng.key(1), lam)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 63 - 1), n=st.integers(1, 300),
       kind=st.sampled_from(['bits32', 'bits64', 'uniform32',
                             'uniform64']))
def test_hypothesis_keys_and_lengths(seed, n, kind):
    k = jax.random.fold_in(jkey(seed), n)
    if kind.startswith('bits'):
        ref = np.asarray(jax.random.bits(
            k, (n,), dtype=jnp.uint32 if kind == 'bits32' else jnp.uint64))
    else:
        ref = np.asarray(jax.random.uniform(
            k, (n,), dtype='f4' if kind == 'uniform32' else 'f8'))
    got = tf.threefry_fill_plain(raw(k), 0, n, kind).numpy()
    np.testing.assert_array_equal(got, ref)


def test_distributed_rng_matches_jax_call_for_call():
    mine = rng.DistributedRNG(42, 500, device='cpu')
    ref = JaxRNG(42, 500)
    for dt in ('f8', 'f4'):
        np.testing.assert_array_equal(
            mine.uniform(itemshape=(3,), dtype=dt).numpy(),
            np.asarray(ref.uniform(itemshape=(3,), dtype=dt)))
        np.testing.assert_array_equal(
            mine.uniform(-2.0, 5.0, dtype=dt).numpy(),
            np.asarray(ref.uniform(-2.0, 5.0, dtype=dt)))
    np.testing.assert_allclose(
        mine.normal(1.5, 2.0, dtype='f8').numpy(),
        np.asarray(ref.normal(1.5, 2.0, dtype='f8')), rtol=0, atol=1e-13)
    lam = np.random.RandomState(2).uniform(0, 20, 500)
    np.testing.assert_array_equal(mine.poisson(torch.from_numpy(lam)).numpy(),
                                  np.asarray(ref.poisson(lam)))
    # choice, the last draw method to be ported, continues the sequence
    np.testing.assert_array_equal(mine.choice([1, 2, 3]).numpy(),
                                  np.asarray(ref.choice([1, 2, 3])))


def test_key_from_numpy_carries_jax_keys():
    k = jax.random.fold_in(jkey(9), 4)
    mine = key_from_numpy(raw(k))
    np.testing.assert_array_equal(
        rng.uniform(mine, (64,), 'f8').numpy(),
        np.asarray(jax.random.uniform(k, (64,), dtype='f8')))
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(3, np.uint32))


def test_wrappers_dispatch_and_refuse_cpu_tensors():
    """The CPU takes the plain versions; the kernel wrappers refuse a
    CPU device or tensor rather than fall back."""
    key = rng.key(3)
    before = tf.threefry_fill_cuda.launches
    np.testing.assert_array_equal(
        tf.threefry_fill(key, 0, 10, 'bits32', device='cpu').numpy(),
        tf.threefry_fill_plain(key, 0, 10, 'bits32').numpy())
    assert tf.threefry_fill_cuda.launches == before
    with pytest.raises(ValueError):
        tf.threefry_fill_cuda(key, 0, 10, 'bits32', device='cpu')
    with pytest.raises(ValueError):
        tf.poisson_threefry_cuda(key, torch.ones(4))
    with pytest.raises(ValueError):
        tf.threefry_fill_plain(key, 0, 4, 'gamma32')


def test_fma_is_correctly_rounded():
    """The emulated fused multiply-add against exact rational
    arithmetic, at f4 and f8."""
    from fractions import Fraction
    rs = np.random.RandomState(4)
    for dt in (np.float32, np.float64):
        a, b, c = (rs.standard_normal(300).astype(dt)
                   * 10.0 ** rs.randint(-3, 4, 300) for _ in range(3))
        got = tf.fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
        for ai, bi, ci, gi in zip(a, b, c, got):
            exact = Fraction(float(ai)) * Fraction(float(bi)) \
                + Fraction(float(ci))
            assert gi == dt(float(exact)) or abs(
                Fraction(float(gi)) - exact) <= abs(
                Fraction(float(dt(float(exact)))) - exact)


def _ulps(a, b):
    it = np.int32 if a.dtype == np.float32 else np.int64
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


def test_xla_arithmetic_gaps():
    """Where the port's float arithmetic stops matching XLA's on the CPU,
    and by how much (the known limit of f4 parity): torch's f32 log
    differs from XLA's in the last bit for ~8% of values; the port's
    XLA-style erf_inv is within 2 ulp at f32 (torch.erfinv: 64) and
    5e-15 at f64; the port's Lanczos lgamma within 2e-6 relative."""
    rs = np.random.RandomState(0)
    x = rs.uniform(1e-6, 10, 10 ** 5).astype(np.float32)
    d = _ulps(np.asarray(jnp.log(x)), torch.log(torch.from_numpy(x)).numpy())
    assert d.max() <= 1 and (d == 0).mean() >= 0.85
    u = rs.uniform(-1, 1, 10 ** 5).astype(np.float32)
    d = _ulps(np.asarray(jax.lax.erf_inv(u)),
              tf.erf_inv(torch.from_numpy(u)).numpy())
    assert d.max() <= 2 and (d == 0).mean() >= 0.98
    u64 = rs.uniform(-1, 1, 10 ** 5)
    np.testing.assert_allclose(tf.erf_inv(torch.from_numpy(u64)).numpy(),
                               np.asarray(jax.lax.erf_inv(u64)), rtol=0,
                               atol=5e-15)
    g = rs.uniform(3, 2000, 10 ** 5).astype(np.float32)
    np.testing.assert_allclose(tf.lgamma_f32(torch.from_numpy(g)).numpy(),
                               np.asarray(jax.lax.lgamma(g)), rtol=2e-6)


def test_plain_versions_do_not_depend_on_their_chunk(monkeypatch):
    """The plain versions work in steps of PLAIN_CHUNK elements; the
    step changes nothing (counters, Knuth and rejection phases)."""
    key = rng.key(3)
    lam = torch.rand(5000, generator=torch.Generator().manual_seed(1)) * 30
    lam[::7] = 0
    ref_p = tf.poisson_threefry_plain(key, lam)
    ref_f = tf.threefry_fill_plain(key, 5, 1000, 'normal64')
    monkeypatch.setattr(tf, 'PLAIN_CHUNK', 77)
    assert torch.equal(tf.poisson_threefry_plain(key, lam), ref_p)
    assert torch.equal(tf.threefry_fill_plain(key, 5, 1000, 'normal64'),
                       ref_f)


# -- the occupied-cells mode ----------------------------------------------

def _cells_fields():
    rs = np.random.RandomState(5)
    mixed = rs.uniform(0, 30, 6000).astype('f4')
    mixed[::7] = 0
    mixed[3::11] = -1.5
    mixed[5::13] = np.nan
    mixed[17] = 1e-40
    return {
        'knuth_only': rs.lognormal(-4, 1.0, 8000).astype('f4'),
        'knuth_dense': rs.uniform(0, 9.9, 4000).astype('f4'),
        'rejection_only': rs.uniform(10, 200, 1500).astype('f4'),
        'mixed_with_zeros_nan_negatives': mixed,
        'all_zero': np.zeros(300, 'f4'),
    }


CELLS_FIELDS = sorted(_cells_fields())


@pytest.mark.parametrize('field', CELLS_FIELDS)
def test_poisson_cells_plain_equals_nonzero_of_counts(field):
    """The occupied-cells plain path gives nonzero() of the full-mesh
    counts over Knuth-only, rejection and mixed fields with zeros, NaN
    and negatives: ids, counts, N and the hashes used."""
    lam = torch.from_numpy(_cells_fields()[field])
    key = rng.key(11)
    sf, sc = {}, {}
    full = tf.poisson_threefry_plain(key, lam, stats=sf)
    ref = torch.nonzero(full).reshape(-1)
    ids, counts, N = tf.poisson_cells_plain(key, lam, stats=sc)
    assert ids.dtype == counts.dtype == torch.int64
    assert torch.equal(ids, ref) and torch.equal(counts, full[ref])
    assert N == int(full.sum()) and sc['hashes'] == sf['hashes']


def _kernel_lists(full, lam):
    """A stand-in for one occupied-cells launch, for the wrapper's side of
    the protocol: it lists every cell with a nonzero count and every
    rejection cell (count 0 included) in raster order, into ``cap``
    entries, and reports the list's full length, the counts' sum and the
    listed rejection cells whose count is 0."""
    listed = torch.nonzero((full != 0) | ~(torch.isnan(lam) | (lam < 10)))
    listed = listed.reshape(-1)

    def run(cap):
        ids = torch.full((cap,), -7, dtype=torch.int64)
        cnts = torch.full((cap,), -7, dtype=torch.int64)
        m = min(cap, listed.numel())
        ids[:m], cnts[:m] = listed[:m], full[listed[:m]]
        w = np.zeros(tf.SCRATCH_WORDS, np.int64)
        w[tf.SCR_OCCUPIED] = listed.numel()
        w[tf.SCR_TOTAL] = int(full.sum())
        w[tf.SCR_ZEROS] = int((cnts[:m] == 0).sum())
        w[tf.SCR_HASHES] = 5
        return ids, cnts, w
    return run, listed.numel()


@pytest.mark.parametrize('capacity', [1, 64, 10 ** 5])
@pytest.mark.parametrize('field', CELLS_FIELDS)
def test_collect_cells_draws_a_short_list_again(field, capacity):
    """The occupied-cells wrapper launches again at the reported length
    when the list was too short for it, and then returns nonzero() of
    the counts."""
    lam = torch.from_numpy(_cells_fields()[field])
    full = tf.poisson_threefry_plain(rng.key(11), lam)
    run, listed = _kernel_lists(full, lam)
    stats = {}
    ids, counts, N = tf._collect_cells(run, capacity, stats)
    ref = torch.nonzero(full).reshape(-1)
    assert torch.equal(ids, ref) and torch.equal(counts, full[ref])
    assert N == int(full.sum())
    relaunched = listed > capacity
    assert stats == dict(hashes=5, runs=2 if relaunched else 1,
                         capacity=listed if relaunched else capacity)


def test_poisson_cells_drop_rejection_cells_that_draw_zero():
    """The kernel lists a rejection cell before its count is known; the
    wrapper drops one whose count comes out 0 (key 31 draws 0 at cell
    2344 of a lam = 10 field)."""
    lam = torch.full((3000,), 10.0)
    lam[::5] = 0.5
    key = rng.key(31)
    full = tf.poisson_threefry_plain(key, lam)
    assert int(full[2344]) == 0 and (full[lam >= 10] == 0).sum() >= 1
    run, listed = _kernel_lists(full, lam)
    ids, counts, N = tf._collect_cells(run, listed, None)
    ref = torch.nonzero(full).reshape(-1)
    assert 2344 not in ids.tolist() and listed > ref.numel()
    assert torch.equal(ids, ref) and torch.equal(counts, full[ref])
    assert N == int(full.sum()) and (counts != 0).all()
    assert all(torch.equal(a, b) for a, b in
               zip(tf.poisson_cells_plain(key, lam)[:2], (ids, counts)))


@pytest.mark.parametrize('dtype', ['f4', 'f8'])
def test_poisson_cells_equal_jax(dtype):
    """ids, counts and N equal the nonzero cells of JAX's
    ``random.poisson`` (what the JAX mock repeats), in every branch."""
    lam = poisson_lams(dtype)
    k = jkey(13)
    ref = np.asarray(jax.random.poisson(k, jnp.asarray(lam)))
    ids, counts, N = tf.poisson_cells(raw(k), torch.from_numpy(lam),
                                      expected=float(np.nansum(lam)))
    nz = np.flatnonzero(ref)
    np.testing.assert_array_equal(ids.numpy(), nz)
    np.testing.assert_array_equal(counts.numpy(), ref[nz])
    assert N == int(ref.sum())


def test_poisson_cells_table_exhausted_raises(monkeypatch):
    monkeypatch.setattr(tf, 'KNUTH_TABLE', 3)
    with pytest.raises(tf.PoissonTableExhausted):
        tf.poisson_cells_plain(rng.key(1), torch.full((100,), 9.0))


def test_poisson_cells_dispatch_and_refuse_cpu_tensors():
    key = rng.key(4)
    lam = torch.rand(200, generator=torch.Generator().manual_seed(2)) * 3
    before = tf.poisson_cells_cuda.launches
    got = tf.poisson_cells(key, lam, float(lam.sum()))
    ref = tf.poisson_cells_plain(key, lam)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], ref[:2]))
    assert got[2] == ref[2] and tf.poisson_cells_cuda.launches == before
    with pytest.raises(ValueError):
        tf.poisson_cells_cuda(key, lam, float(lam.sum()))
    with pytest.raises(ValueError):
        tf.poisson_screen_check(device='cpu')
