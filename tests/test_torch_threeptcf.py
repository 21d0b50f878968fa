"""The three-point function through the PyTorch port and the JAX package
on the same seeded numpy catalogs: SimulationBox3PCF (periodic) and
SurveyData3PCF (the bounding-box path) at poles 0-4 to 1e-10 relative;
``threept_alm_plain`` against the JAX fold body (``_se_chunk_zeta`` on
one chunk); the port against a numpy brute-force triplet sum; the
non-periodic double-count guard; YlmCache; the JSON save."""

import functools
import json

import numpy as np
import pytest
import torch

import nbodykit_tpu_torch
from nbodykit_tpu.algorithms import threeptcf as jthree
from nbodykit_tpu.algorithms.convpower.fkp import get_real_Ylm as jylm
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.ops.gridhash import GridHash as JGridHash
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JArray
from nbodykit_tpu_torch.algorithms import threeptcf as tthree
from nbodykit_tpu_torch.binned_statistic import BinnedStatistic
from nbodykit_tpu_torch.cosmology import Planck15
from nbodykit_tpu_torch.lab import (ArrayCatalog, SimulationBox3PCF,
                                    SurveyData3PCF, YlmCache)
from nbodykit_tpu_torch.ops.devicehash import GridHash
from nbodykit_tpu_torch.ops.threept_cuda import lm_table, threept_alm_plain

BOX = 100.0
N = 1500
EDGES = np.array([2.0, 6.0, 10.0, 15.0])
POLES = [0, 1, 2, 3, 4]
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _on_cpu():
    # one intra-op thread: the plain folds are many small ops, and the
    # thread pools of parallel test workers slow each by milliseconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with nbodykit_tpu_torch.set_options(device='cpu'):
            yield
    finally:
        torch.set_num_threads(threads)


def columns(seed=5):
    rng = np.random.RandomState(seed)
    return {'Position': rng.uniform(0, BOX, (N, 3)),
            'Weight': rng.uniform(0.5, 1.5, N)}


def close(got, want):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= RTOL * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def box_results():
    cols = columns()
    return (jthree.SimulationBox3PCF(JArray(cols, BoxSize=BOX), POLES,
                                     EDGES),
            SimulationBox3PCF(ArrayCatalog(cols, BoxSize=BOX), POLES, EDGES))


@pytest.mark.parametrize('ell', POLES)
def test_simulation_box_3pcf(ell):
    want, got = box_results()
    close(got.poles['corr_%d' % ell], want.poles['corr_%d' % ell])
    assert np.abs(got.poles['corr_%d' % ell]).max() > 0


def test_survey_3pcf():
    rng = np.random.RandomState(6)
    cols = {'RA': rng.uniform(0, 20, 900), 'DEC': rng.uniform(-10, 10, 900),
            'Redshift': rng.uniform(0.03, 0.05, 900),
            'Weight': rng.uniform(0.5, 1.5, 900)}
    want = jthree.SurveyData3PCF(JArray(cols), [0, 2], EDGES, JPlanck15)
    got = SurveyData3PCF(ArrayCatalog(cols), [0, 2], EDGES, Planck15)
    for ell in (0, 2):
        close(got.poles['corr_%d' % ell], want.poles['corr_%d' % ell])
    assert np.abs(got.poles['corr_0']).max() > 0


@pytest.mark.parametrize('periodic', [True, False])
def test_plain_alm_matches_the_jax_fold_body(periodic):
    """The moments of one chunk of queries (with dead entries), folded
    into zeta as the JAX chunk does, against ``_se_chunk_zeta``."""
    import jax.numpy as jnp
    cols = columns(7)
    pos, w = cols['Position'], cols['Weight']
    q = slice(0, 700)
    live = np.arange(700) % 5 != 2
    jgrid = JGridHash(pos, np.full(3, BOX), EDGES[-1], periodic=periodic)
    ylms = [(ell, [jylm(ell, m) for m in range(-ell, ell + 1)])
            for ell in POLES]
    chunk = jthree._se_chunk_zeta(jgrid, jnp.asarray(w[jgrid.order]), ylms,
                                  len(EDGES) - 1, jnp.asarray(EDGES ** 2))
    want = np.asarray(chunk((jnp.asarray(pos[q]), jnp.asarray(w[q]),
                             jnp.asarray(live))))

    grid = GridHash(pos, np.full(3, BOX), EDGES[-1], periodic=periodic)
    p = torch.as_tensor(pos[q])
    alm = threept_alm_plain(grid, torch.as_tensor(w)[grid.order], p,
                            torch.as_tensor(live), grid.cell_of(p),
                            EDGES ** 2, POLES)
    assert alm.shape == (700, len(lm_table(POLES)[0]), len(EDGES) - 1)
    assert float(alm[~torch.as_tensor(live)].abs().max()) == 0.0
    ilm = 0
    for i, ell in enumerate(POLES):
        a = alm[:, ilm:ilm + 2 * ell + 1]
        z = torch.einsum('i,imb,imc->bc', torch.as_tensor(w[q]), a, a) \
            / (4 * np.pi)
        close(z.numpy(), want[i])
        ilm += 2 * ell + 1


def brute_zeta(pos, w, edges, ell, box):
    """sum_i w_i sum_{j in b1, k in b2} w_j w_k P_l(cos theta_jik),
    periodic distances (the JAX package's test oracle)."""
    from numpy.polynomial.legendre import legval
    nb = len(edges) - 1
    out = np.zeros((nb, nb))
    c = np.zeros(ell + 1)
    c[ell] = 1.0
    for i in range(len(pos)):
        d = pos - pos[i]
        d -= np.round(d / box) * box
        r = np.sqrt((d ** 2).sum(axis=-1))
        idx = np.flatnonzero((r > 0) & (r >= edges[0]) & (r < edges[-1]))
        if len(idx) == 0:
            continue
        rv = d[idx] / r[idx][:, None]
        bins = np.digitize(r[idx], edges) - 1
        mu = np.clip(rv @ rv.T, -1, 1)
        out += np.einsum('a,b,ab,ai,bj->ij', w[idx], w[idx], legval(mu, c),
                         np.eye(nb)[bins], np.eye(nb)[bins]) * w[i]
    return out


@pytest.mark.parametrize('ell', [0, 1, 2, 3])
def test_3pcf_against_brute_force(ell):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 20.0, size=(60, 3))
    w = rng.uniform(0.5, 1.5, size=60)
    edges = np.array([0.5, 4.0, 8.0])
    r = SimulationBox3PCF(ArrayCatalog({'Position': pos, 'Weight': w},
                                       BoxSize=20.0), [ell], edges)
    want = brute_zeta(pos, w, edges, ell, 20.0) \
        * (2 * ell + 1) / (4 * np.pi) ** 2
    close(r.poles['corr_%d' % ell], want)


def test_nonperiodic_no_double_count():
    """Two pairs at opposite corners of a non-periodic bounding box: each
    point has one neighbour, nothing is visited twice."""
    pos = np.array([[0.1, 0.1, 0.1], [1.0, 0.1, 0.1],
                    [9.9, 9.9, 9.9], [9.0, 9.9, 9.9]])

    class Direct(tthree.Base3PCF):
        def __init__(self):
            self.attrs = dict(poles=[0], edges=np.array([0.5, 1.5]))
            self.poles = self._run(torch.as_tensor(pos),
                                   torch.ones(4, dtype=torch.float64),
                                   np.array([0.5, 1.5]), [0], BoxSize=None)

    got = Direct().poles['corr_0'][0, 0]
    assert got == pytest.approx(4.0 / (4 * np.pi) ** 2, rel=1e-14)


def test_ylm_cache_matches_jax():
    rng = np.random.RandomState(8)
    v = rng.normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=-1)[:, None]
    xpy = v[:, 0] + 1j * v[:, 1]
    want = jthree.YlmCache([0, 2, 3])(xpy, v[:, 2])
    got = YlmCache([0, 2, 3])(xpy, v[:, 2])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-12, atol=1e-14)
    t = YlmCache([1])(torch.as_tensor(xpy), torch.as_tensor(v[:, 2]))
    assert isinstance(t[(1, 1)], torch.Tensor) and t[(1, 1)].is_complex()


def kernel_ylm(ell, m, norm, wmm, x, y, z):
    """The kernel's all_ylm (csrc/threept_alm.cu) for one Y_lm in Python
    floats: the recurrence multiplies by 1 / (l - m)."""
    ma = abs(m)
    W = wmm
    if ell > ma:
        Wp, W = W, z * (2 * ma + 1) * wmm
        for ll in range(ma + 2, ell + 1):
            Wp, W = W, ((2 * ll - 1) * z * W - (ll + ma - 1) * Wp) \
                * (1.0 / (ll - ma))
    if ma == 0:
        return norm * W * 1.0
    re, im = x, y
    for _ in range(ma - 1):
        re, im = re * x - im * y, re * y + im * x
    return norm * W * (re if m >= 0 else im)


def test_lm_table_gives_get_real_ylm():
    """The constants the kernel receives, through the kernel's recurrence,
    give the port's get_real_Ylm at poles 0-6."""
    from nbodykit_tpu_torch.algorithms.convpower.fkp import get_real_Ylm
    rng = np.random.RandomState(9)
    v = rng.normal(size=(20, 3))
    v /= np.linalg.norm(v, axis=-1)[:, None]
    t = torch.as_tensor(v)
    ells = list(range(7))
    table = list(zip(*lm_table(ells)))
    assert [(ell, m) for ell, m, _, _ in table] == [
        (ell, m) for ell in ells for m in range(-ell, ell + 1)]
    for ell, m, norm, wmm in table:
        want = get_real_Ylm(ell, m)(t[:, 0], t[:, 1], t[:, 2]).numpy()
        got = [kernel_ylm(ell, m, norm, wmm, *row) for row in v]
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_3pcf_save(tmp_path):
    _, got = box_results()
    path = str(tmp_path / 'zeta.json')
    got.save(path)
    from nbodykit_tpu_torch.utils import JSONDecoder
    with open(path) as f:
        state = json.load(f, cls=JSONDecoder)
    back = BinnedStatistic.from_state(state['poles'])
    for ell in POLES:
        np.testing.assert_array_equal(back['corr_%d' % ell],
                                      got.poles['corr_%d' % ell])
    assert list(state['attrs']['poles']) == POLES
