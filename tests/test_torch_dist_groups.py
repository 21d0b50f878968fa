"""The 3PCF, CylindricalGroups, FiberCollisions, the direct bispectrum
and HOD population across ranks against the JAX package. One world of 4
gloo CPU ranks (``tests/_torch_ranks.py`` ``group_cases``) answers every
case at P = 1, 2 and 4 on N = 4096 and 4099 objects (the clustered
catalog, its sky variant for the survey 3PCF and FiberCollisions, seeded
halos).

Bars, against JAX's one device (its multi-device programs compile for
tens of seconds a case on this CPU): each ``corr_ell`` within 1e-12 of
its largest value; CGM's columns bit for bit, and its rounds equal to
the port's one rank; the modes within 1e-12 of sum |w|, B within 1e-10
of its largest value and ntri identical; the galaxies at P > 1 bit for
bit the port's one rank, which holds JAX's at tests/test_torch_hod.py's
bars. FiberCollisions at P > 1 numbers its groups by the slab rule (the
least global index), as the JAX package does on a mesh: its Label,
Collided and NeighborID equal JAX's ``_assign_fibers`` on the one-device
partition relabelled by that rule, bit for bit, and P = 1 equals JAX's
one-device FiberCollisions.
"""

import functools

import numpy as np
import pytest

import _torch_ranks as R
from nbodykit_tpu import hod as jhod
from nbodykit_tpu.algorithms.bispectrum import direct_bispectrum as jax_bs
from nbodykit_tpu.algorithms.cgm import CylindricalGroups as JaxCGM
from nbodykit_tpu.algorithms.fibercollisions import \
    FiberCollisions as JaxFiber
from nbodykit_tpu.algorithms.threeptcf import (
    SimulationBox3PCF as JaxBox3PCF, SurveyData3PCF as JaxSurvey3PCF)
from nbodykit_tpu.cosmology import Planck15 as JPlanck15
from nbodykit_tpu.ops.pairblock import (lattice_kvecs,
                                        pairblock_sum as jax_pairblock)
from nbodykit_tpu.algorithms.bispectrum import shell_modes
from nbodykit_tpu.source.catalog.array import ArrayCatalog as JaxArray
from nbodykit_tpu.source.catalog.halos import HaloCatalog as JaxHalos
from nbodykit_tpu.transform import SkyToUnitSphere
from _torch_threads import one_torch_thread  # noqa: F401

Ps = R.RANK_COUNTS
parts = R.parts
CGM_COLUMNS = ('cgm_type', 'cgm_haloid', 'num_cgm_sats')
FIBER_COLUMNS = ('Label', 'Collided', 'NeighborID')


@pytest.fixture(scope='module')
def world():
    return R.run_world('group_cases')


def joined(got, col):
    return np.concatenate([g[col] for g in got])


# -- the 3PCF ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_3pcf(case, n=None):
    if case == '3pcf':
        pc = JaxBox3PCF(JaxArray(R.clustered(n), BoxSize=R.BOX), R.GR_POLES,
                        R.GR_3PT_EDGES)
    elif case == '3pcf_survey':
        pc = JaxSurvey3PCF(JaxArray(R.sky(n)), R.GR_POLES, R.GR_SKY_EDGES,
                           JPlanck15)
    elif case == '3pcf_wide':
        pc = JaxBox3PCF(JaxArray(R.sparse_columns(), BoxSize=R.BOX),
                        R.GR_POLES, R.PT_WIDE_EDGES)
    else:
        pc = JaxSurvey3PCF(JaxArray(R.sky(R.PT_SPARSE)), R.GR_POLES,
                           R.PT_WIDE_EDGES, JPlanck15)
    return {'corr_%d' % ell: np.asarray(pc.poles['corr_%d' % ell])
            for ell in R.GR_POLES}


@pytest.mark.parametrize('case', ['3pcf', '3pcf_survey'])
def test_3pcf_slab_equals_jax(world, case):
    """SimulationBox3PCF and SurveyData3PCF take the slab branch at P =
    2 and 4 (the survey's box is every rank's bounding box) and every
    rank's zetas equal JAX's one device and the port's one rank within
    1e-12 of each multipole's largest value."""
    n = R.GR_AT[case]
    want = jax_3pcf(case, n)
    assert np.abs(want['corr_0']).max() > 0
    one = world[0][case, n, 1]
    assert one['branch'] == 'one_rank'
    for P in Ps:
        for got in parts(world, (case, n), P):
            assert got['branch'] == ('one_rank' if P == 1 else 'slab')
            for col, w in want.items():
                R.close(got[col], w, 1e-12)
                R.close(got[col], one[col], 1e-12)


def test_3pcf_wide_radius_gathers(world):
    """A largest edge past a slab at P = 4 (13 > 50 / 4, and past the
    sky box's quarter) gathers the catalog on every rank; at P = 2 it
    fits a slab. Both equal JAX's one device."""
    for case in ('3pcf_wide', '3pcf_survey_wide'):
        want = jax_3pcf(case)
        for P in Ps:
            for got in parts(world, (case,), P):
                assert got['branch'] == {1: 'one_rank', 2: 'slab',
                                         4: 'gathered'}[P], (case, P)
                for col, w in want.items():
                    R.close(got[col], w, 1e-12)


# -- CylindricalGroups -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_cgm(case):
    if case == 'cgm_wide':
        cgm = JaxCGM(JaxArray(R.sparse_columns(), BoxSize=R.BOX), None,
                     *R.GR_CYL_WIDE)
    else:
        n = R.GR_AT[case]
        d = R.clustered(n)
        if case == 'cgm':
            cgm = JaxCGM(JaxArray(d, BoxSize=R.BOX), R.GR_RANKBY, *R.GR_CYL)
        else:
            cgm = JaxCGM(JaxArray(d), R.GR_RANKBY, *R.GR_CYL, periodic=False)
    return {c: np.asarray(cgm.groups[c]) for c in CGM_COLUMNS}


@pytest.mark.parametrize('case', ['cgm', 'cgm_open'])
def test_cgm_equals_jax(world, case):
    """Periodic in the box, and open in every rank's bounding box, with
    ties in both ``rankby`` columns: the slab branch's cgm_type,
    cgm_haloid (global indices) and num_cgm_sats, in the row split, bit
    for bit JAX's one device, and its rounds the port's one rank's."""
    n = R.GR_AT[case]
    want = jax_cgm(case)
    assert want['cgm_type'].sum() > 0
    one = world[0][case, n, 1]
    assert one['branch'] == 'one_rank' and one['rounds'] >= 2
    for P in Ps:
        got = parts(world, (case, n), P)
        for c in CGM_COLUMNS:
            np.testing.assert_array_equal(joined(got, c), want[c], err_msg=c)
        assert all(g['rounds'] == one['rounds'] for g in got)
        assert all(g['branch'] == ('one_rank' if P == 1 else 'slab')
                   for g in got)
        assert [len(g['cgm_type']) for g in got] == \
            [len(R.rows(want['cgm_type'], P, r)) for r in range(P)]


def test_cgm_wide_radius_gathers(world):
    """A cylinder past a slab at P = 4 gathers the catalog; the groups
    and rounds equal JAX's and the port's one rank."""
    want = jax_cgm('cgm_wide')
    one = world[0]['cgm_wide', 1]
    for P in Ps:
        got = parts(world, ('cgm_wide',), P)
        for c in CGM_COLUMNS:
            np.testing.assert_array_equal(joined(got, c), want[c], err_msg=c)
        assert all(g['branch'] == {1: 'one_rank', 2: 'slab',
                                   4: 'gathered'}[P] for g in got)
        assert all(g['rounds'] == one['rounds'] for g in got)


# -- FiberCollisions ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_fiber(n):
    """JAX's one-device FiberCollisions, and the slab-rule oracle: its
    partition relabelled by descending size, equal sizes by ascending
    least member, then JAX's ``_assign_fibers`` on those labels."""
    s = R.sky(n)
    fc = JaxFiber(s['RA'], s['DEC'], collision_radius=R.GR_FIBER_RADIUS,
                  seed=R.GR_FIBER_SEED)
    one = {c: np.asarray(fc.labels[c]) for c in FIBER_COLUMNS}
    lab = one['Label']
    grouped = np.flatnonzero(lab > 0)
    least = {}
    for i in grouped:
        least.setdefault(lab[i], i)
    sizes = np.bincount(lab)
    groups = sorted(least, key=lambda g: (-sizes[g], least[g]))
    relabel = np.zeros(sizes.shape[0], dtype=lab.dtype)
    relabel[groups] = np.arange(1, len(groups) + 1)
    slab = relabel[lab]
    pos = np.asarray(SkyToUnitSphere(s['RA'], s['DEC']))
    collided, neighbors = fc._assign_fibers(pos, slab, R.GR_FIBER_SEED)
    return one, {'Label': slab, 'Collided': collided,
                 'NeighborID': neighbors}


def test_fibercollisions_one_rank_equals_jax(world):
    for n in R.NPARTS:
        one, _ = jax_fiber(n)
        got = world[0]['fiber', n, 1]
        assert (one['Label'] > 0).sum() > 0 and one['Collided'].sum() > 0
        assert np.bincount(one['Label'])[1:].max() >= 3
        for c in FIBER_COLUMNS:
            np.testing.assert_array_equal(got[c], one[c], err_msg=c)


def test_fibercollisions_slab_numbering(world):
    """At P = 2 and 4 the partition is the one rank's, and Label,
    Collided and NeighborID (global indices) equal JAX's assignment on
    the slab branch's numbering, bit for bit, in the row split."""
    for n in R.NPARTS:
        one, want = jax_fiber(n)
        for P in Ps[1:]:
            got = parts(world, ('fiber', n), P)
            for c in FIBER_COLUMNS:
                np.testing.assert_array_equal(joined(got, c), want[c],
                                              err_msg=c)
            lab = joined(got, 'Label')
            np.testing.assert_array_equal(lab > 0, one['Label'] > 0)
            np.testing.assert_array_equal(
                np.bincount(lab), np.bincount(want['Label']))


# -- the direct bispectrum ---------------------------------------------------------

def test_pairblock_sum_equals_jax(world):
    """Every rank's modes within 1e-12 of sum |w| of JAX's one-device
    sum."""
    q, _ = shell_modes(R.GR_BS_NBINS)
    for n in R.NPARTS:
        d = R.clustered(n)
        want = np.asarray(jax_pairblock(d['Position'], d['Weight'],
                                        lattice_kvecs(q, R.BOX), tile=1024))
        scale = np.abs(d['Weight']).sum()
        for P in Ps:
            for got in parts(world, ('pairblock', n), P):
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-12 * scale)


def test_direct_bispectrum_equals_jax(world):
    """direct_bispectrum and Bispectrum(method='direct') across ranks: B
    within 1e-10 of JAX's largest |B|, ntri and its NaN pattern
    identical; the class keeps the catalog's comm."""
    for n in R.NPARTS:
        d = R.clustered(n)
        B, ntri = jax_bs(d['Position'], d['Weight'], R.BOX, R.GR_BS_NBINS,
                         tile=1024)
        m = ~np.isnan(B)
        scale = np.abs(B[m]).max()
        for P in Ps:
            for got in parts(world, ('direct_bs', n), P):
                assert got['comm_kept']
                for b, t in ((got['B'], got['ntri']),
                             (got['cls_B'], got['cls_ntri'])):
                    np.testing.assert_array_equal(np.isnan(b), ~m)
                    np.testing.assert_array_equal(t[m], ntri[m])
                    np.testing.assert_allclose(b[m], B[m], rtol=0,
                                               atol=1e-10 * scale)


# -- HOD population ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_galaxies(n, name):
    cols = R.halo_columns(n)
    jl = dict(HaloCatalog=JaxHalos, ArrayCatalog=JaxArray,
              Planck15=JPlanck15)
    gal = R.halos_of(jl, cols).populate(getattr(jhod, name),
                                        seed=R.GR_HOD_SEED)
    return {c: np.asarray(gal[c]) for c in ('Position', 'Velocity',
                                            'gal_type', 'HaloMass')}


@pytest.mark.parametrize('n', R.NPARTS)
def test_populate_across_ranks(world, n):
    """HaloCatalog.populate on P ranks keeps the halos' comm and gives
    the one rank's galaxies bit for bit, in the row split; the one rank
    equals JAX's one device at test_torch_hod.py's bars (Zheng07 at N =
    4096, Hearin15 with its own Concentration column at 4099)."""
    name = R.GR_AT['populate'][n]
    want = jax_galaxies(n, name)
    one = world[0]['populate', n, name, 1]
    ngal = len(want['gal_type'])
    assert 0 < want['gal_type'].sum() < ngal
    np.testing.assert_array_equal(one['gal_type'], want['gal_type'])
    np.testing.assert_allclose(one['HaloMass'], want['HaloMass'],
                               rtol=1e-12, atol=0)
    for c in ('Position', 'Velocity'):
        np.testing.assert_allclose(one[c], want[c], rtol=1e-10,
                                   atol=1e-10 * R.BOX, err_msg=c)
    for P in Ps:
        got = parts(world, ('populate', n, name), P)
        assert all(g['comm_kept'] and g['csize'] == ngal and
                   g['seed'] == R.GR_HOD_SEED for g in got)
        for c in ('Position', 'Velocity', 'gal_type', 'HaloMass'):
            np.testing.assert_array_equal(joined(got, c), one[c], err_msg=c)
        assert [len(g['gal_type']) for g in got] == \
            [len(R.rows(want['gal_type'], P, r)) for r in range(P)]


def test_drawn_seeds_are_rank0s(world):
    """``HODModel(seed=None)`` and ``FiberCollisions(seed=None)`` give
    one seed on every rank."""
    for P in Ps[1:]:
        got = parts(world, ('seeds',), P)
        for key in ('populate', 'fiber'):
            assert len({g[key] for g in got}) == 1, (P, key, got)
