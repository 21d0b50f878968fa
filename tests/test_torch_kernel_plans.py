"""Launch geometry of the port's two Hopper kernels, checked without a
card: the deposit's tile, cluster and shared-memory plan
(``ops/paint_cuda.deposit_plan``) and the rank pass's chunk, CTA and
scratch plan (``ops/radix_cuda.rank_plan``), against the limits of the
H100 and the constants compiled into ``csrc/*.cu``."""

import os
import re

import pytest

from nbodykit_tpu_torch import kernel_variants
from nbodykit_tpu_torch.ops import paint_cuda, radix_cuda
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
