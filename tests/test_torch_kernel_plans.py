"""Launch geometry of the port's Hopper kernels, checked without a
card: the deposit's tile, cluster and shared-memory plan
(``ops/paint_cuda.deposit_plan``), the rank pass's chunk, CTA and
scratch plan (``ops/radix_cuda.rank_plan``) and the LSD digits of the
keys it orders (``ops/radix.digit_plan``), the Poisson draw's tiles,
alignment shift, scratch and list capacity
(``ops/threefry_cuda.poisson_plan``, ``cell_capacity``) and the FOF
kernels' byte counts (``ops/fof_cuda.sweep_bytes``, ``link_*_bytes``,
``fixpoint_bytes``), against the limits of the H100 and the constants
compiled into ``csrc/*.cu``."""

import os
import re

import pytest

from nbodykit_tpu_torch import kernel_variants
from nbodykit_tpu_torch.ops import fof_cuda, paint_cuda, radix, radix_cuda
from nbodykit_tpu_torch.ops import threefry_cuda
from nbodykit_tpu_torch.ops.paint import mxu_plan
from nbodykit_tpu_torch.ops.window import RESAMPLERS

# shared memory a CTA may use on Hopper
H100_SMEM_PER_CTA = 232448
CSRC = os.path.join(os.path.dirname(paint_cuda.__file__), os.pardir, 'csrc')


def _define(source, name):
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(r'^#define %s \(?(\w+)' % name, f.read(), re.M)
    return int(m.group(1))


def _tile(resampler, N2, itemsize):
    """The (M, N2) tile mxu_plan gives a full N2^3 mesh."""
    plan = mxu_plan(10 ** 5, (N2,) * 3, resampler, (N2,) * 3, itemsize)
    s = plan['s']
    return (plan['rb'] + s - 1) * (plan['cb'] + s - 1)


PLAN_CASES = [(r, it, N2) for r in sorted(RESAMPLERS) for it in (4, 8)
              for N2 in (32, 100, 250, 512, 1024)]


@pytest.mark.parametrize('resampler,itemsize,N2', PLAN_CASES)
def test_deposit_plan_fits_and_tiles_z(resampler, itemsize, N2):
    M = _tile(resampler, N2, itemsize)
    plan = paint_cuda.deposit_plan(M, N2, itemsize)
    assert plan['smem_bytes'] + paint_cuda.SMEM_STATIC <= H100_SMEM_PER_CTA
    assert plan['smem_bytes'] % 16 == 0
    assert plan['smem_bytes'] >= M * plan['zc'] * itemsize
    assert 1 <= plan['nz'] <= paint_cuda.MAX_CLUSTER
    assert plan['portable'] == (plan['nz'] <= 8)
    # the cluster's z ranges cover [0, N2) once, none of them empty
    ranges = plan['z_ranges']
    assert len(ranges) == plan['nz']
    assert ranges[0][0] == 0 and ranges[-1][1] == N2
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(1 <= z1 - z0 <= plan['zc'] for z0, z1 in ranges)
    if plan['nz'] == 1:
        assert plan['zc'] == N2
    else:
        # a whole tile does not fit one CTA, and each range starts on a
        # 16-byte boundary of its row
        assert M * N2 * itemsize > H100_SMEM_PER_CTA - 128
        assert (plan['zc'] * itemsize) % 16 == 0


@pytest.mark.parametrize('M,N2,itemsize,nz,zc,ragged', [
    (81, 512, 4, 1, 512, False),       # CIC f32, the main path
    (100, 512, 4, 1, 512, False),      # TSC f32
    (121, 512, 4, 2, 256, False),      # PCS f32
    (81, 512, 8, 2, 256, False),       # CIC f64
    (121, 512, 8, 3, 172, False),      # PCS f64
    (121, 1024, 8, 5, 206, False),     # PCS f64 at N2 = 1024
    (81, 250, 4, 1, 250, True),        # CIC f32, rows not 16-byte aligned
])
def test_deposit_plan_cases(M, N2, itemsize, nz, zc, ragged):
    plan = paint_cuda.deposit_plan(M, N2, itemsize)
    assert (plan['nz'], plan['zc'], plan['ragged']) == (nz, zc, ragged)


def test_deposit_plan_flags_non_portable_clusters_and_refuses_too_big():
    # rb = cb = 16 PCS tiles of f64 cells at N2 = 1024: 2.96 MB
    plan = paint_cuda.deposit_plan(19 * 19, 1024, 8)
    assert plan['nz'] > 8 and not plan['portable']
    with pytest.raises(ValueError):
        paint_cuda.deposit_plan(40 * 40, 1024, 8)
    with pytest.raises(ValueError):
        paint_cuda.deposit_plan(81, 512, 2)


C = radix_cuda.KERNEL_CHUNK
RANK_N = [1, C - 1, C, C + 1, 9998863]


@pytest.mark.parametrize('n', RANK_N)
@pytest.mark.parametrize('D', [1, 65, 1024])
def test_rank_plan(n, D):
    plan = radix_cuda.rank_plan(n, D)
    chunk = plan['chunk']
    assert chunk == radix_cuda.KERNEL_CHUNK == 8192
    assert (plan['ctas'] - 1) * chunk < n <= plan['ctas'] * chunk
    ctas = plan['ctas']
    # ticket, status words padded to 16 bytes, 2 * D int32 per chunk
    assert plan['clear_bytes'] == 16 + 16 * (-(-4 * ctas // 16))
    assert plan['clear_bytes'] % 16 == 0
    assert 8 * plan['scratch_words'] >= plan['clear_bytes'] + 8 * ctas * D
    assert 8 * plan['scratch_words'] < plan['clear_bytes'] + 8 * ctas * D + 8
    assert plan['smem_bytes'] <= H100_SMEM_PER_CTA
    assert plan['ctas'] * chunk < 2 ** 31
    if n == 9998863:
        assert plan['ctas'] == 1221


def test_rank_plan_empty_stream_still_has_one_cta():
    assert radix_cuda.rank_plan(0, 65)['ctas'] == 1


def test_plans_match_the_kernel_sources():
    assert _define('paint_deposit.cu', 'DEP_THREADS') \
        == paint_cuda.DEPOSIT_THREADS
    assert _define('radix_rank.cu', 'RANK_THREADS') \
        == radix_cuda.KERNEL_THREADS
    per = _define('radix_rank.cu', 'RANK_PER_THREAD')
    assert per * radix_cuda.KERNEL_THREADS == radix_cuda.KERNEL_CHUNK
    for name in ('POISSON_THREADS', 'POISSON_VEC', 'POISSON_UNROLL'):
        assert _define('threefry.cu', name) == getattr(threefry_cuda, name)
    assert _define('threefry.cu', 'SCR_WORDS') == threefry_cuda.SCRATCH_WORDS
    for name in ('SCR_ITERS', 'SCR_OVERFLOW', 'SCR_HASHES', 'SCR_TOTAL',
                 'SCR_OCCUPIED', 'SCR_ZEROS', 'SCR_TICKET'):
        assert _define('threefry.cu', name) == getattr(threefry_cuda, name)
    assert _define('fof_sweep.cu', 'SWEEP_THREADS') == fof_cuda.SWEEP_THREADS


# (alphabet, passes, base): the 512^3 and 1024^3 paint buckets, the
# convpower paint (16513), the FOF grid at desi_like (1077^3 cells and
# the sentinel), and the edges of one and two passes
DIGITS = [(1, 1, 1), (1024, 1, 1024), (1025, 2, 33), (16513, 2, 129),
          (1077 ** 3 + 1, 4, 189), (2 ** 31 - 1, 4, 216)]


@pytest.mark.parametrize('D,passes,base', DIGITS)
def test_digit_plan(D, passes, base):
    assert radix.digit_plan(D) == (passes, base)
    assert base ** passes >= D and base <= radix_cuda.MAX_DIGITS
    if passes > 1:
        assert (base - 1) ** passes < D


@pytest.mark.parametrize('n', [1, 10002365])
def test_sweep_bytes(n):
    # f4 positions with int32 ids: 37 bytes a query; f8 with int64: 53
    assert fof_cuda.sweep_bytes(n, 4, 4) == 37 * n
    assert fof_cuda.sweep_bytes(n, 8, 8) == 53 * n


# the FOF flow's grid (1077^3 cells, n = 1e7, E links), a grid of int64
# ids at f8, and a tiny one
FOF_GRIDS = [((1077, 1077, 1077), 10002365, 4, 4, 337000),
             ((2048, 1024, 1024), 5000, 8, 8, 12),
             ((1, 2, 3), 1, 4, 4, 0)]


@pytest.mark.parametrize('ncell,n,pb,kb,E', FOF_GRIDS)
def test_link_kernel_bytes(ncell, n, pb, kb, E):
    ncol = 4 * (ncell[0] * ncell[1] + 1)
    assert fof_cuda.column_bytes(ncell) == ncol
    if ncell[0] == 1077:
        assert ncol == 4 * 1159930              # 4.6 MB: fits the L2
    q = 3 * pb + 12 + kb + 1                    # a query's inputs
    # the column-table entries the queries reach: the whole table, or a
    # few (a sparse grid's queries reach a small part of it)
    for entries in (ncol // 4, 7):
        assert fof_cuda.link_count_bytes(n, pb, kb, entries) \
            == n * (q + 4) + 4 * entries
        assert fof_cuda.link_fill_bytes(n, E, pb, kb, entries) \
            == n * q + 8 * (n + 1) + 4 * entries + 4 * E
    # row offsets, labels in and out, the links: 16 B a particle and 4 a
    # link (the labels a link gathers are the labels read once)
    assert fof_cuda.links_sweep_bytes(n, E) == 16 * n + 8 + 4 * E
    # the whole fixpoint: 29 + 8 S bytes a particle at f4 with int32 ids
    for sweeps in (1, 7):
        assert fof_cuda.fixpoint_bytes(n, sweeps, pb, kb) \
            == n * (q + 8 * sweeps)
    if pb == kb == 4:
        assert fof_cuda.fixpoint_bytes(n, 7, 4, 4) == n * (29 + 56)


POISSON_N = [1, 3, 16383, 16384, 16385, 2 ** 20 + 3, 1024 ** 3]


@pytest.mark.parametrize('n', POISSON_N)
@pytest.mark.parametrize('shift', [0, 1, 2, 3])
def test_poisson_plan(n, shift):
    plan = threefry_cuda.poisson_plan(n, shift)
    tile = plan['tile']
    assert tile == threefry_cuda.POISSON_TILE == 16384
    assert tile == plan['threads'] * threefry_cuda.POISSON_VEC \
        * threefry_cuda.POISSON_UNROLL
    # the tiles cover the cells at [shift, shift + n) of the aligned
    # slots, each once
    assert (plan['tiles'] - 1) * tile < n + shift <= plan['tiles'] * tile
    assert plan['out_words'] == n + shift
    assert plan['scratch_words'] == threefry_cuda.SCRATCH_WORDS \
        + plan['tiles']
    assert plan['clear_bytes'] == 8 * plan['scratch_words']
    assert plan['clear_bytes'] % 8 == 0
    if n == 1024 ** 3:
        assert plan['tiles'] == 65536 + (shift > 0)


@pytest.mark.parametrize('n,shift', [(0, 0), (10, 4), (10, -1)])
def test_poisson_plan_refuses(n, shift):
    with pytest.raises(ValueError):
        threefry_cuda.poisson_plan(n, shift)


@pytest.mark.parametrize('expected,n,cap', [
    (1e7, 1024 ** 3, 10026323),      # the lognormal path: nbar V = 1e7
    (3750.0, 32 ** 3, 5264),         # the mock tests' 32^3 mesh
    (0.0, 10, 10),                   # never more than the cells
    (float('nan'), 10 ** 6, 1024),   # a sum that is no sum: the floor
    (float('inf'), 10 ** 6, 1024),
    (-5.0, 10 ** 6, 1024),
    (0.0, 1, 1),
])
def test_cell_capacity(expected, n, cap):
    got = threefry_cuda.cell_capacity(expected, n)
    assert got == cap and 1 <= got <= n
    if 0 < expected < float('inf') and n > 10 ** 5:
        # 8 sigma of the Poisson count sum that bounds the occupied cells
        assert got >= expected + 8 * expected ** 0.5


@pytest.mark.parametrize('name', sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_the_sources(name):
    # every substitution of the design-step timing script still finds its
    # text in the kernel source, and changes it
    src, subs, what = kernel_variants.VARIANTS[name]
    with open(os.path.join(CSRC, src + '.cu')) as f:
        text = f.read()
    for old, new in subs:
        assert text.count(old) >= 1 and old != new
    assert what


def test_particle_kernels_match_their_sources():
    """The pair-count and 3PCF wrappers' constants, shared-memory sizes
    and mode numbers against csrc/paircount.cu and csrc/threept_alm.cu."""
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    from nbodykit_tpu_torch.ops import threept_cuda as tc
    assert _define('paircount.cu', 'PC_THREADS') == pc.PC_THREADS
    assert _define('paircount.cu', 'PC_TAB_MAX') == pc.PC_TAB_MAX
    assert _define('threept_alm.cu', 'TA_THREADS') == tc.TA_THREADS
    assert _define('threept_alm.cu', 'TA_ITEM') == tc.TA_ITEM
    assert _define('threept_alm.cu', 'TA_NB') == tc.TA_NB
    assert _define('threept_alm.cu', 'TA_LMAX') == tc.TA_LMAX
    assert _define('threept_alm.cu', 'TA_TAB_MAX') == pc.PC_TAB_MAX
    assert _define('grid_columns.cuh', 'GC_RUNS') == 18
    with open(os.path.join(CSRC, 'paircount.cu')) as f:
        src = f.read()
    assert 'enum { MODE_1D = 0, MODE_2D = 1, MODE_PROJECTED = 2 };' in src
    assert pc.MODES == {'1d': 0, 'angular': 0, '2d': 1, 'projected': 2}
    # '1d' with 30 edges: two tiles of 128 candidates (32 bytes each), a
    # table of 158 entries (16 bytes), 30 edges, 31 bins of totals (16
    # bytes), rows 0..29 private to each thread (8 bytes a row, the
    # counts 4 bytes a row a warp) and 18 runs (3 ints): five CTAs an SM
    assert pc.smem_bytes('1d', 30, 1, 158) == 2 * 128 * 32 + 158 * 16 \
        + 30 * 8 + 31 * 16 + 30 * (128 * 8 + 4 * 4) + 18 * 12
    assert 5 * (pc.smem_bytes('1d', 30, 1, 158) + 1024) <= 228 * 1024
    # '2d' (31 x 10 bins): a shared histogram and the 10 columns of the
    # overflow row private to each thread; 'projected' (22 x 60): the
    # shared histogram, nothing private
    assert pc.private_rows('2d', 30, 10) == 10
    assert pc.private_rows('projected', 21, 60) == 0
    assert pc.smem_bytes('2d', 30, 10, 158) == 2 * 128 * 32 + 158 * 16 \
        + 30 * 8 + 310 * 16 + 310 * 12 + 10 * (128 * 8 + 4 * 4) + 18 * 12
    assert pc.smem_bytes('projected', 21, 60, 28) == 2 * 128 * 32 \
        + 28 * 16 + 21 * 8 + 1320 * 16 + 1320 * 12 + 18 * 12
    assert pc.hist_bins(21, 60) == 22 * 60
    for mode, nedges, nb2 in (('1d', 30, 1), ('2d', 30, 10),
                              ('projected', 21, 60), ('angular', 11, 1)):
        assert pc.smem_bytes(mode, nedges, nb2, pc.PC_TAB_MAX + 1) \
            <= pc.SMEM_LIMIT
    assert (_define('threept_alm.cu', 'QCAP'),
            _define('threept_alm.cu', 'QBATCH')) == (tc.QCAP, tc.QBATCH)
    # poles 0-4 (25 harmonics, lmax 4), 13 bins: the moments in
    # registers; the head (a table of 48 entries, edges, norms, W_mm,
    # 1/k, l's first index, runs) rounded to 16, 4 warps of a queue of 64
    # pairs and a batch's 32 x 25 harmonics
    assert tc.moments_in_registers(13, 4)
    head = 48 * 16 + 8 * 14 + 8 * 25 + 24 * 5 + 18 * 12
    assert tc.smem_bytes(13, 25, 4, 48) == -(-head // 16) * 16 \
        + 4 * (64 * 36 + 32 * 25 * 8)
    # poles 0-6 (49 harmonics), pole 5 alone (11) and 17 bins: the
    # moments in shared memory
    assert not tc.moments_in_registers(13, 6)
    assert not tc.moments_in_registers(13, 5)
    assert not tc.moments_in_registers(17, 4)
    head = 48 * 16 + 8 * 14 + 8 * 11 + 24 * 6 + 18 * 12
    assert tc.smem_bytes(13, 11, 5, 48) == -(-head // 16) * 16 \
        + 4 * (64 * 36 + 32 * 11 * 8 + 11 * 13 * 8)
    assert tc.smem_bytes(13, 49, 6, 48) > tc.smem_bytes(13, 25, 4, 48)
    assert tc.smem_bytes(13, 25, 4, pc.PC_TAB_MAX + 1) < tc.SMEM_LIMIT


@pytest.mark.parametrize('mode,los,periodic,ops', [
    ('1d', 2, True, 11), ('2d', 'midpoint', False, 36),
    ('projected', 2, True, 16)])
def test_candidate_ops(mode, los, periodic, ops):
    from nbodykit_tpu_torch.ops.paircount_cuda import candidate_ops
    # the minimum image costs nothing where it leaves d as it is
    assert candidate_ops(mode, los) == ops


def test_weight_products():
    from nbodykit_tpu_torch.ops.paircount_cuda import weight_products
    # one product a candidate, or one a (query, bin) with w2 summed first
    assert weight_products(4500, 1000, 31) == 4500
    assert weight_products(6.6e9, 10 ** 6, 31) == 31 * 10 ** 6


def test_visited_candidates():
    from nbodykit_tpu_torch.ops.paircount_cuda import visited_candidates
    # every point is its own candidate once; the rest are pairs seen
    # from both ends
    assert visited_candidates(1000 + 2 * 4500, 1000, True) == 4500
    assert visited_candidates(7000, 1000, False) == 7000


def test_ylm_ops_and_bytes():
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    from nbodykit_tpu_torch.ops import threept_cuda as tc
    # ell 0: the unit vector (5) and one Y_00 (norm and azimuthal
    # products: 2); its weight product and sum on the tensor cores (2)
    assert tc.ylm_ops([0]) == 7
    assert tc.ylm_mma_ops([0]) == 2
    # ell 1: the recurrence's first step (2), 3 harmonics of 2 each, the
    # unit vector (5)
    assert tc.ylm_ops([1]) == 5 + 2 + 6
    assert tc.ylm_mma_ops([1]) == 6
    # poles 0-4: m = 0 steps 2 + 5 * 3, m = 1 2 + 5 * 2, m = 2 6 + 2 + 5,
    # m = 3 6 + 2, m = 4 6; 25 harmonics
    assert tc.ylm_ops([0, 1, 2, 3, 4]) == 5 + 17 + 12 + 13 + 8 + 6 + 50
    assert tc.ylm_mma_ops([0, 1, 2, 3, 4]) == 50
    assert tc.alm_bytes(10, 20, 4, 5, 3, 4) == 10 * (37 + 96) + 20 * 36 \
        + 20 + 32
    assert pc.hist_bytes(10, 20, 8, 5, 4, 2) == 450 + 800 + 20 + 32 + 160
