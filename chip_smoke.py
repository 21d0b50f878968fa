#!/usr/bin/env python3
"""Drive the PyTorch port (``nbodykit_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``nbodykit_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, and
drives six paths through the user entry points:

- the main path: a UniformCatalog of ~1e7 threefry particles painted
  onto a 512^3 CIC mesh, compensated, FFTPower in (k, mu) with
  multipoles; then FFTCorr and ProjectedFFTPower once on its mesh;
- the lognormal path, the repo's FFTPower benchmark flow
  (``benchmarks/test_fftpower.py`` at its ``desi_like`` scale):
  LogNormalCatalog(LinearPower(Planck15, 0.55, 'EisensteinHu'),
  bias=2, seed=42) at BoxSize 5000, Nmesh 1024, nbar 1e7 / 5000^3,
  then FFTPower(mode='2d', kmin=0.001, Nmu=10) on its compensated CIC
  mesh;
- the convpower path, the repo's ConvolvedFFTPower benchmark flow
  (``benchmarks/test_convpower.py`` at ``desi_like``): data and 10x
  randoms UniformCatalogs (seeds 42, 84) at BoxSize 5000 with NZ = nbar,
  FKPCatalog(...).to_mesh(Nmesh=1024, resampler='tsc') in f8, then
  ConvolvedFFTPower(poles=[0, 2, 4], dk=0.005);
- the FOF path, the repo's FOF benchmark flow (``benchmarks/test_fof.py``
  at ``desi_like``): the lognormal path's catalog, FOF(linking_length=0.2,
  nmin=20).to_halos(1e12, Planck15, 0.0) and the halo positions on the
  host, then populate(Zheng07Model, seed=42) once;
- the FFTRecon path: that catalog as data, ~1e8 uniform randoms (seed
  84), FFTRecon(Nmesh=512, bias=2, f=0.77, R=15, scheme='LGS') and
  FFTPower(mode='1d') of the reconstructed field;
- the CLASS path (after the lognormal path): the Boltzmann library
  built with g++, the native solve against the scipy path, Planck15
  from its shipped table and one fresh solve; the lognormal flow with
  the default LinearPower(Planck15, 0.55) (the CLASS transfer); on its
  mesh and catalog, compute(Nmesh=...) down and up, preview, sort and
  DistributedRNG.choice; HalofitPower, ZeldovichPower,
  CorrelationFunction and LinearNbody;

and LinearMesh at the same scale against its exact expectation. Every
check is an ``assert`` or a raise, so any failure exits non-zero.
Output: one JSON line per phase; then the ``kernels`` line, the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Without CUDA it exits 1 and prints no result. Times are
CUDA-event times on this card.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W);
# F64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
# Integer issue on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput): IADD3, LOP3 and SHF go to the ALU
# pipe and IMAD to the FMA pipe, each 64 results per clock per SM, and
# the two run side by side; an SM issues at most 4 warp-instructions
# (128 thread instructions) per clock. kernel_variants.py checks the
# assignment on the card (pipe_probe).
ALU_OPCODES = ('IADD3', 'LOP3', 'SHF')
FMA_OPCODES = ('IMAD',)
PIPE_PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 128
# calls per timed phase of the main path, and of the lognormal path
REPS = 5
LN_REPS = 3
# the lognormal path: benchmarks/test_fftpower.py at desi_like
LN_BOX, LN_NMESH, LN_N, LN_BIAS, LN_SEED = 5000.0, 1024, 1e7, 2.0, 42


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=10, warmup=1):
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timed(fn):
    """(result, CUDA-event ms) of one call of ``fn``."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def spread(fn, reps):
    """(last result, {median, min, max} ms): ``reps`` calls of ``fn``,
    one CUDA-event window each."""
    out, ts = None, []
    for _ in range(reps):
        out, t = timed(fn)
        ts.append(t)
    return out, {'median': float(np.median(ts)), 'min': min(ts),
                 'max': max(ts)}


def bound(nbytes, flops, peak_flops):
    """(ms, 'bytes' or 'operations'): the least time of the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def smi_query(query):
    """``nvidia-smi --query-gpu=<query>`` of card 0, as printed."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=%s' % query, '--format=csv,noheader'],
        capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def sm_clock():
    """(boost clock in MHz, SMs): ``clocks.max.sm`` and the SM count."""
    mhz = float(smi_query('clocks.max.sm').split()[0])
    return mhz, torch.cuda.get_device_properties(0).multi_processor_count


def rank_cases(gen):
    """(label, digits, D) of the rank pass's checks: random digits at n
    around one chunk and at the main path's sizes for D in {1, 2, 65,
    129, 1024} (65 and 129 are the LSD digits of the 512^3 and the
    1024^3 CIC bucket alphabets), then all-equal, sorted and
    reverse-sorted digits."""
    from nbodykit_tpu_torch.ops.radix_cuda import KERNEL_CHUNK as C

    def rand(n, D):
        return torch.randint(0, D, (n,), generator=gen, device='cuda',
                             dtype=torch.int32)
    for n in (1, C - 1, C, C + 1, 10 ** 6, 10 ** 7):
        for D in (1, 2, 65, 129, 1024):
            yield 'random n=%d D=%d' % (n, D), rand(n, D), D
    for D in (65, 129, 1024):
        n = 10 ** 6
        yield 'all_equal D=%d' % D, torch.full(
            (n,), D - 1, dtype=torch.int32, device='cuda'), D
        srt = torch.sort(rand(n, D))[0]
        yield 'sorted D=%d' % D, srt, D
        yield 'reverse_sorted D=%d' % D, torch.flip(srt, (0,)), D


def check_rank():
    """The rank kernel against its plain version; bit-identical in
    every case, and in 10 repeated launches on one input (a look-back
    race would show there)."""
    from nbodykit_tpu_torch.ops.radix import stable_key_order
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   raise_on_bad_digits)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(7)
    cases = []
    for label, d, D in rank_cases(gen):
        rk, hk = pass_rank_hist_cuda(d, D)
        rp, hp = pass_rank_hist_plain(d, D)
        torch.cuda.synchronize()
        assert torch.equal(rk, rp), "rank mismatch: %s" % label
        assert torch.equal(hk, hp), "hist mismatch: %s" % label
        cases.append(label)
    raise_on_bad_digits('cuda')
    emit({'phase': 'rank_check', 'bit_identical': cases})
    for D in (65, 129, 1024):
        d = torch.randint(0, D, (10 ** 7,), generator=gen, device='cuda',
                          dtype=torch.int32)
        rp, hp = pass_rank_hist_plain(d, D)
        for rep in range(10):
            rk, hk = pass_rank_hist_cuda(d, D)
            assert torch.equal(rk, rp) and torch.equal(hk, hp), \
                "repeat %d of the rank pass at D=%d differs" % (rep, D)
        emit({'phase': 'rank_check', 'n': 10 ** 7, 'D': D,
              'repeats_bit_identical': 10})
    raise_on_bad_digits('cuda')
    # a digit outside [0, D) is skipped by the kernel, counted on the
    # device and raised on at the next read of the count
    d = torch.randint(0, 65, (10 ** 5,), generator=gen, device='cuda',
                      dtype=torch.int32)
    d[12345] = 65
    pass_rank_hist_cuda(d, 65)
    try:
        raise_on_bad_digits('cuda')
    except ValueError:
        pass
    else:
        raise AssertionError("an out-of-range digit was not reported")
    raise_on_bad_digits('cuda')                      # the count was reset
    emit({'phase': 'rank_check', 'bad_digit_reported': True})
    key = torch.randint(0, 4161, (10 ** 7,), generator=gen, device='cuda',
                        dtype=torch.int32)
    order = stable_key_order(key, 4161)
    assert torch.equal(order, torch.argsort(key, stable=True)), \
        "stable_key_order(D=4161) differs from a stable argsort"
    raise_on_bad_digits('cuda')
    emit({'phase': 'rank_check', 'n': 10 ** 7, 'D': 4161,
          'stable_key_order_equals_argsort': True})


def kernel_device_ms(fn, names, reps=10):
    """Device time per call of each CUDA kernel whose name contains one
    of ``names``, from ``torch.profiler`` over ``reps`` calls of
    ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for nm in names:
            if nm in e.key:
                out[nm] = out.get(nm, 0.0) + _device_us(e) / 1e3 / reps
    return out


def time_rank(n, D=65, plain_reps=2, digits=None):
    """Rank pass times at the main path's shape (n particles, 2 LSD
    passes of 65 digits at 512^3), on random digits or on ``digits``:
    the kernel alone (CUDA events around the C call into preallocated
    outputs, the status words' clearing included, and the kernel's
    device time from the profiler), the wrapper (checks and
    allocation), the plain version and ``torch.argsort``."""
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   rank_pass_launch,
                                                   rank_plan)
    if digits is None:
        gen = torch.Generator(device='cuda')
        gen.manual_seed(11)
        d = torch.randint(0, D, (n,), generator=gen, device='cuda',
                          dtype=torch.int32)
    else:
        d = digits.to(torch.int32).contiguous()
    rank = torch.empty_like(d)
    hist = torch.empty(D, dtype=torch.int32, device='cuda')
    plan = rank_plan(n, D)
    scratch = torch.empty(plan['scratch_words'], dtype=torch.int64,
                          device='cuda')

    def launch():
        rank_pass_launch(d, D, rank, hist, scratch)
    ms = cuda_ms(launch, reps=20)
    wrapper_ms = cuda_ms(lambda: pass_rank_hist_cuda(d, D), reps=20)
    split = kernel_device_ms(launch, ('rank_lookback_kernel', 'Memset'))
    plain_ms = cuda_ms(lambda: pass_rank_hist_plain(d, D), reps=plain_reps,
                       warmup=min(1, plain_reps - 1))
    lib_ms = cuda_ms(lambda: torch.argsort(d, stable=True), reps=10)
    b_ms, b_by = bound(n * 4 + n * 4 + D * 4, 0, F32_FLOPS)
    emit({'phase': 'rank_timing', 'n': n, 'D': D, 'kernels_ms': ms,
          'wrapper_ms': wrapper_ms, 'device_ms_per_kernel': split,
          'bound_ms': b_ms, 'ctas': plan['ctas'],
          'clear_bytes': plan['clear_bytes']})
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0, at='n=%d D=%d' % (n, D))


def deposit_case(label, pos_cells, mass, shape, period, origin, resampler,
                 slack=2.0, check_order=False, stripes=None):
    """Kernel vs plain deposit on the mxu payload of one catalog, or on
    its first ``stripes`` x-stripes (a sub-block of the blocks). With
    ``check_order``, the payload bucketed by the radix rank passes must
    equal the one bucketed by a stable ``torch.argsort``. Returns (mxu
    plan, payload, geometry, max |kernel - plain|, deposit launch
    plan)."""
    from nbodykit_tpu_torch.ops.paint import mxu_payload, mxu_plan
    from nbodykit_tpu_torch.ops.paint_cuda import (deposit_blocks_cuda,
                                                   deposit_blocks_plain,
                                                   deposit_plan)
    plan = mxu_plan(pos_cells.shape[0], shape, resampler, period,
                    mass.element_size(), slack=slack)
    sx, sy, sz, sm, over = mxu_payload(pos_cells, mass, plan, resampler,
                                       origin, 'radix')
    assert int(over) == 0, "bucket overflow in %s" % label
    if check_order:
        ref = mxu_payload(pos_cells, mass, plan, resampler, origin,
                          'argsort')
        for a, b in zip((sx, sy, sz, sm, over), ref):
            assert torch.equal(a, b), \
                "%s: radix bucketing differs from argsort's" % label
        del ref
    geom = dict(resampler=resampler, rb=plan['rb'], cb=plan['cb'],
                n0l=int(shape[0]), p0=int(period[0]), N1=int(shape[1]),
                N2=int(shape[2]), origin=origin)
    sub = (sx, sy, sz, sm) if stripes is None else \
        tuple(a[:stripes].contiguous() for a in (sx, sy, sz, sm))
    got = deposit_blocks_cuda(*sub, **geom)
    ref = deposit_blocks_plain(*sub, ck=plan['ck'], **geom)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = (1e-12 if sm.dtype == torch.float64 else 1e-5) * scale
    total, mass_in = float(got.double().sum()), float(sub[3].double().sum())
    lplan = deposit_plan(got.shape[2], got.shape[3], got.element_size())
    blocks = list(got.shape)
    del got, ref, sub
    emit({'phase': 'deposit_check', 'case': label, 'max_abs_err': err,
          'max_abs_block': scale, 'tol': tol, 'blocks': blocks,
          'cluster': lplan['nz'], 'z_cells_per_cta': lplan['zc'],
          'ragged': lplan['ragged'], 'blocks_sum': total,
          'payload_mass': mass_in, 'radix_equals_argsort': check_order,
          'stripes_checked': stripes or blocks[0]})
    assert np.isfinite(err) and err <= tol, \
        "deposit %s: max |kernel - plain| %g > %g" % (label, err, tol)
    # every window sums to one: the blocks hold the payload's mass
    assert abs(total - mass_in) <= 1e-5 * mass_in, \
        "deposit %s does not conserve mass" % label
    return plan, (sx, sy, sz, sm), geom, err, lplan


def uniform_cells(n, nmesh, seed, dtype=torch.float64):
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    return torch.rand((n, 3), generator=gen, device='cuda',
                      dtype=dtype) * nmesh


def check_deposit(cat, nmesh):
    """The deposit kernel against its plain version: the main path's
    512^3 CIC stripes; TSC and PCS at 256^3 / 1e6; a slab block with
    origin != 0; f8 meshes; each cluster size the plan gives at 512^3
    (PCS f4: 2 CTAs, CIC f8: 2, PCS f8: 3); rows that are not 16-byte
    aligned (CIC f4 at 250^3, TSC f8 at 130^3); and 1e6 particles in
    four cells, for atomic contention. Returns the main-path record."""
    full = (nmesh,) * 3
    pos = cat['Position'] * (nmesh / float(cat.attrs['BoxSize'][0]))
    mass = torch.ones(pos.shape[0], dtype=torch.float32, device='cuda')
    plan, payload, geom, err, _ = deposit_case(
        'cic %d^3 n=%d' % (nmesh, pos.shape[0]), pos, mass, full, full, 0,
        'cic', check_order=True)
    cells = uniform_cells(10 ** 6, 256, seed=3)
    ones = torch.ones(10 ** 6, dtype=torch.float32, device='cuda')
    for res in ('tsc', 'pcs'):
        deposit_case('%s 256^3 n=1e6' % res, cells, ones, (256,) * 3,
                     (256,) * 3, 0, res)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(5)
    w = torch.rand(10 ** 6, generator=gen, device='cuda',
                   dtype=torch.float32) + 0.5
    deposit_case('cic slab n0l=64 origin=100 of 256^3', cells, w,
                 (64, 256, 256), (256,) * 3, 100, 'cic')
    deposit_case('tsc 128^3 n=2e5 f8 mesh',
                 uniform_cells(2 * 10 ** 5, 128, seed=9),
                 torch.ones(2 * 10 ** 5, dtype=torch.float64, device='cuda'),
                 (128,) * 3, (128,) * 3, 0, 'tsc')
    cells = uniform_cells(10 ** 6, nmesh, seed=13)
    for res, dt in (('pcs', torch.float32), ('cic', torch.float64),
                    ('pcs', torch.float64)):
        deposit_case('%s %d^3 n=1e6 %s mesh' % (res, nmesh, str(dt)[-7:]),
                     cells, torch.ones(10 ** 6, dtype=dt, device='cuda'),
                     full, full, 0, res)
    deposit_case('cic 250^3 n=1e6 (rows not 16-byte aligned)',
                 uniform_cells(10 ** 6, 250, seed=17), ones, (250,) * 3,
                 (250,) * 3, 0, 'cic')
    deposit_case('tsc 130^3 n=2e5 f8 mesh',
                 uniform_cells(2 * 10 ** 5, 130, seed=19),
                 torch.ones(2 * 10 ** 5, dtype=torch.float64, device='cuda'),
                 (130,) * 3, (130,) * 3, 0, 'tsc')
    # 1e6 particles in four cells of a 32^3 mesh; the slack lets one
    # bucket hold them all (1 / the bucket's share of the mesh is 16).
    # An f8 mesh: 250,000 f32 terms in one cell would round by more than
    # the f32 tolerance in any summation order.
    corner = torch.tensor([[3, 5, 7], [3, 5, 8], [20, 9, 31], [0, 0, 0]],
                          dtype=torch.float64, device='cuda')
    which = torch.arange(10 ** 6, device='cuda') % 4
    clumped = corner[which] + uniform_cells(10 ** 6, 1, seed=23)
    deposit_case('cic 32^3 n=1e6 in 4 cells f8 mesh', clumped, w.double(),
                 (32,) * 3, (32,) * 3, 0, 'cic', slack=17.0)

    return time_deposit(payload, geom, plan, err)


def time_deposit(payload, geom, plan, err, plain=True):
    """The deposit kernel's time on one payload (10 launches), its plain
    version's (one call, when ``plain``) and the bound of the work:
    every slot's mass read, the positions of the occupied slots read,
    the blocks written once; 2 flops for each of the s^3 terms of an
    occupied slot, at the peak of the mesh dtype."""
    from nbodykit_tpu_torch.ops.paint_cuda import (deposit_blocks_cuda,
                                                   deposit_blocks_plain)
    from nbodykit_tpu_torch.ops.window import window_support
    sx, sy, sz, sm = payload
    ms = cuda_ms(lambda: deposit_blocks_cuda(sx, sy, sz, sm, **geom),
                 reps=10)
    plain_ms = cuda_ms(lambda: deposit_blocks_plain(
        sx, sy, sz, sm, ck=plan['ck'], **geom), reps=1, warmup=0) \
        if plain else None
    s = window_support(geom['resampler'])
    M = (plan['rb'] + s - 1) * (plan['cb'] + s - 1)
    T, nty, K = sx.shape
    N2 = geom['N2']
    occupied = int((sm != 0).sum())
    nbytes = T * nty * K * sm.element_size() \
        + occupied * 3 * sx.element_size() \
        + T * nty * M * N2 * sm.element_size()
    peak = F64_FLOPS if sm.dtype == torch.float64 else F32_FLOPS
    b_ms, b_by = bound(nbytes, occupied * 2 * s ** 3, peak)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, share_of_bound=b_ms / ms,
                at='%s %s %d^3 blocks %s payload %s, %d slots occupied' % (
                    geom['resampler'], str(sm.dtype)[6:], N2,
                    [T, nty, M, N2], [T, nty, K], occupied))


def launch_counters():
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_cuda
    from nbodykit_tpu_torch.ops.radix_cuda import pass_rank_hist_cuda
    return {'radix_rank': pass_rank_hist_cuda,
            'paint_deposit': deposit_blocks_cuda,
            'threefry_fill': tf.threefry_fill_cuda,
            'poisson_threefry': tf.poisson_threefry_cuda,
            'poisson_cells': tf.poisson_cells_cuda,
            'fof_sweep_search': fc.fof_sweep_cuda,
            'fof_sweep_links': fc.fof_links_sweep_cuda,
            'fof_link_count': fc.fof_link_count_cuda,
            'fof_link_fill': fc.fof_link_fill_cuda}


# the FOF's kernels: no other path launches them
FOF_KERNELS = ('fof_sweep', 'fof_sweep_search', 'fof_sweep_links',
               'fof_link_count', 'fof_link_fill')


@contextlib.contextmanager
def counted_launches():
    """Every kernel's launch count set to 0 on entry; the dict yielded
    holds the counts on exit, after a synchronize, and ``fof_sweep``,
    the sweep kernel's launches in either mode."""
    counters = launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = {}
    yield out
    torch.cuda.synchronize()
    out.update({k: fn.launches for k, fn in counters.items()})
    out['fof_sweep'] = out['fof_sweep_search'] + out['fof_sweep_links']


def main_path(cat, nmesh):
    """FFTPower on the catalog at full width through the user entry
    points, with every kernel's launches counted."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.algorithms.fftpower import (FFTPower,
                                                        project_to_basis)

    def run():
        mesh = cat.to_mesh(Nmesh=nmesh, resampler='cic', compensated=True)
        return mesh, FFTPower(mesh, mode='2d', Nmu=5, poles=[0, 2, 4])

    run()                                            # warm-up
    with counted_launches() as launches:
        t0 = time.perf_counter()
        mesh, r = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    assert launches['paint_deposit'] >= 1, launches
    assert launches['radix_rank'] >= 2, launches

    # the checks of the painted field against the plain scatter paint
    field = mesh.to_real_field()
    mean = float(field.value.double().mean())
    assert abs(mean - 1) < 1e-5, "painted field mean %r" % mean
    with set_options(paint_method='scatter'):
        plain, scatter = spread(lambda: mesh.to_real_field(), REPS)
    diff = float((plain.value - field.value).abs().max())
    fmax = float(field.value.abs().max())
    assert diff <= 1e-5 * fmax, \
        "mxu paint vs index_add_ paint: %g > 1e-5 * %g" % (diff, fmax)
    del plain

    # phases, REPS calls each, one CUDA-event window per call. The whole
    # run is the 3-D power (paint, compensation, r2c, |delta_k|^2) plus
    # the binning plus host work around them; the paint and the r2c are
    # parts of the 3-D power.
    edges = [np.asarray(r.power.edges['k']), np.linspace(-1, 1, 6)]
    _, whole = spread(run, REPS)
    y3d, power3d = spread(lambda: r._compute_3d_power(r.first, r.second)[0],
                          REPS)
    _, binning = spread(lambda: project_to_basis(y3d, edges,
                                                 poles=[0, 2, 4]), REPS)
    del y3d
    field, paint = spread(lambda: mesh.to_real_field(), REPS)
    _, fft = spread(lambda: field.r2c(), REPS)
    parts = power3d['median'] + binning['median']
    slack = sum(p['max'] - p['min'] for p in (whole, power3d, binning))
    phases = {'run': whole, 'power3d': power3d, 'binning': binning,
              'paint_mxu': paint, 'r2c': fft, 'paint_scatter': scatter,
              'power3d_plus_binning_median': parts,
              'run_minus_parts_median': whole['median'] - parts,
              'spreads_sum': slack,
              'split_within_spread': abs(whole['median'] - parts) <= slack}

    # the result: finite, the expected shape, and flat shot noise
    shot = r.attrs['shotnoise']
    P = r.power['power'].real
    modes = r.power['modes']
    assert P.shape == (len(edges[0]) - 1, 5), P.shape
    assert np.isfinite(P[modes > 0]).all()
    knyq = np.pi * nmesh / float(cat.attrs['BoxSize'][0])
    poles = r.poles
    sel = (poles['modes'] > 0) & (poles['k'] < knyq / 2)
    wts = poles['modes'][sel]
    ratio = {ell: float(np.sum(wts * poles['power_%d' % ell][sel].real)
                        / np.sum(wts) / shot) for ell in (0, 2, 4)}
    assert abs(ratio[0] - 1) < 0.02, "P0/shotnoise = %r" % ratio[0]
    # P2, P4 of a Poisson sample vanish in expectation; the mode-weighted
    # means over ~1e6 modes scatter by ~1e-3 of the shot noise
    assert abs(ratio[2]) < 0.02 and abs(ratio[4]) < 0.02, ratio
    emit({'phase': 'main_path', 'nmesh': nmesh, 'npart': len(cat),
          'launches': launches, 'wall_s': wall_s, 'reps': REPS,
          'phases_ms': phases, 'field_mean': mean,
          'mxu_vs_scatter_max_abs': diff, 'shotnoise': shot,
          'P_over_shot_mean_k_lt_half_nyq': ratio,
          'nbins_k': int(P.shape[0])})
    return launches, run


def paint_breakdown(cat, nmesh):
    """The mxu paint's stages at the main path's shapes, REPS calls each
    with one CUDA-event window per call: bucketing (keys, 2 radix passes,
    payload gather), the deposit kernel, and the fold of the tile blocks
    into the mesh."""
    from nbodykit_tpu_torch.ops.paint import mxu_fold, mxu_payload, mxu_plan
    from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_cuda
    full = (nmesh,) * 3
    pos = cat['Position'] * (nmesh / float(cat.attrs['BoxSize'][0]))
    mass = torch.ones(pos.shape[0], dtype=torch.float32, device='cuda')
    plan = mxu_plan(pos.shape[0], full, 'cic', full, 4)
    payload, bucket = spread(lambda: mxu_payload(pos, mass, plan, 'cic', 0,
                                                 'radix'), REPS)
    geom = dict(resampler='cic', rb=plan['rb'], cb=plan['cb'], n0l=nmesh,
                p0=nmesh, N1=nmesh, N2=nmesh, origin=0)
    blocks, dep = spread(lambda: deposit_blocks_cuda(*payload[:4], **geom),
                         REPS)
    _, fold = spread(lambda: mxu_fold(blocks, plan, full=True), REPS)
    emit({'phase': 'paint_breakdown', 'reps': REPS,
          'bucket_and_gather_ms': bucket, 'deposit_ms': dep,
          'fold_ms': fold})


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        val = getattr(evt, attr, None)
        if val is not None:
            return val
    return 0


def profile_main_path(run, path='main_512'):
    """One run of a path under ``torch.profiler``: device busy time, the
    idle share of the run's wall time and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    emit({'phase': 'profile', 'path': path, 'wall_ms_profiled': wall_ms,
          'device_busy_ms': busy_ms,
          'device_idle_share': (1 - busy_ms / wall_ms) if busy_ms else None,
          'device_time_visible': bool(busy_ms),
          'top_kernels': [[e.key[:90], e.count, _device_us(e) / 1e3]
                          for e in top]})


def _same(a, b):
    """(cells that differ, max |difference| in ulp) of two tensors of
    one dtype, compared as bit patterns."""
    ints = {1: torch.int8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    ia, ib = a.view(ints).long(), b.view(ints).long()
    nd = int((ia != ib).sum())
    return nd, int((ia - ib).abs().max()) if nd else 0


def rng_keys():
    """(label, key): seeds 0, 42 and 2^31 - 1, and each one's fold_in
    and split children."""
    from nbodykit_tpu_torch import rng
    for seed in (0, 42, 2 ** 31 - 1):
        k = rng.key(seed)
        yield 'seed=%d' % seed, k
        yield 'fold_in(seed=%d, 1)' % seed, rng.fold_in(k, 1)
        yield 'split(seed=%d)[1]' % seed, rng.split(k)[1]


def check_rng():
    """threefry_fill and poisson_threefry against their plain versions:
    bits (32, 64) bit-identical for n in {1, 2, 3, 1023, 2^20+1} under
    nine keys and n = 1e8 under three, and past counter 2^32; uniforms
    and normals (f32, f64) bit-identical; then the Poisson kernel in
    both modes (:func:`check_poisson`)."""
    from nbodykit_tpu_torch.ops import threefry_cuda as tf

    def pair(key, c0, n, kind, lo=0.0, hi=1.0):
        a = tf.threefry_fill_cuda(key, c0, n, kind, lo, hi, device='cuda')
        b = tf.threefry_fill_plain(key, c0, n, kind, lo, hi, device='cuda')
        return _same(a, b)

    cases = 0
    keys = list(rng_keys())
    for i, (label, key) in enumerate(keys):
        sizes = [1, 2, 3, 1023, 2 ** 20 + 1] + ([10 ** 8] if i % 3 == 0
                                                else [])
        for n in sizes:
            for kind in ('bits32', 'bits64'):
                nd, _ = pair(key, 0, n, kind)
                assert nd == 0, "%s n=%d %s: %d differ" % (kind, n, label, nd)
                cases += 1
        for kind, lo, hi in (('uniform32', 0.0, 1.0),
                             ('uniform64', 0.0, 1.0),
                             ('uniform32', -3.3, 7.1),
                             ('uniform64', 2.5, 1000.0),
                             ('normal32', 0.0, 1.0), ('normal64', 0.0, 1.0)):
            for n in (1023, 2 ** 20 + 1, 10 ** 7):
                nd, ulp = pair(key, 0, n, kind, lo, hi)
                assert nd == 0, "%s n=%d %s: %d differ (%d ulp)" % (
                    kind, n, label, nd, ulp)
                cases += 1
    c0 = 2 ** 32 - 2 ** 19
    for kind in tf.KINDS:
        nd, _ = pair(keys[1][1], c0, 2 ** 20, kind)
        assert nd == 0, "%s past 2^32: %d differ" % (kind, nd)
        cases += 1
    emit({'phase': 'rng_check', 'kernel': 'threefry_fill',
          'cases_bit_identical': cases,
          'kinds': list(tf.KINDS), 'largest_n': 10 ** 8,
          'counter_past_2^32': c0})

    check_poisson(keys[1][1])


def poisson_case(key, label, lam, expected=None):
    """Both modes of the Poisson kernel on one lam against the plain
    version: the full-mesh counts bit for bit, the occupied cells
    (ids, counts, N) equal to nonzero() of the plain counts, and the
    same number of hashes in all three. The list is sized for
    ``expected`` (default: the sum of lam's finite positive cells).
    Returns the plain counts and the occupied-cells stats."""
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    if expected is None:
        expected = float(lam.double().nan_to_num(0.0, 0.0, 0.0)
                         .clamp(min=0).sum())
    sk, sc, sp = {}, {}, {}
    a = tf.poisson_threefry_cuda(key, lam, stats=sk)
    b = tf.poisson_threefry_plain(key, lam, stats=sp)
    nd = int((a != b).sum())
    del a
    flat = b.reshape(-1)
    ref = torch.nonzero(flat).reshape(-1)
    ids, cnts, N = tf.poisson_cells_cuda(key, lam, expected, stats=sc)
    same = bool(torch.equal(ids, ref) and torch.equal(cnts, flat[ref])
                and N == int(flat.sum()))
    rejection = int((~(torch.isnan(lam) | (lam < 10))).sum())
    emit({'phase': 'rng_check', 'kernel': 'poisson_threefry',
          'field': label, 'cells': lam.numel(),
          'lam_offset_cells': (lam.data_ptr() // 4) % 4,
          'differing_cells_full_mesh': nd,
          'occupied_cells_equal_nonzero': same,
          'occupied': int(ref.numel()), 'N': N,
          'rejection_cells': rejection, 'hashes_full_mesh': sk['hashes'],
          'hashes_occupied_cells': sc['hashes'], 'hashes_plain': sp['hashes'],
          'occupied_cells_launches': sc['runs'],
          'capacity': sc['capacity']})
    assert nd == 0, "poisson %s: %d cells differ" % (label, nd)
    assert same, "poisson %s: occupied cells differ from nonzero()" % label
    assert sk['hashes'] == sp['hashes'] == sc['hashes'], (sk, sc, sp)
    return b, sc


def check_poisson(key0):
    """poisson_threefry in both modes against its plain version: a 256^3
    lognormal lam (Knuth only), lam in [0, 50] with zeros (both
    samplers), exact zeros, negatives, NaN, +-inf and both sides of the
    switch at 10, lam views 1-3 cells past 16-byte alignment and lengths
    that are no multiple of the vector width, a lam that puts every
    cell's Knuth stop decision on its boundary, a list sized too small
    (the kernel reports it, the wrapper draws again); the
    __logf screen's margin over every uniform; a cell past either
    subkey table raises in both modes."""
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    key = tf.split_key(key0)[0]
    bad, worst = tf.poisson_screen_check()
    emit({'phase': 'rng_check', 'kernel': 'poisson_threefry',
          'logf_screen_uniforms_checked': 2 ** 23 - 1,
          'logf_screen_margin_violations': bad,
          'logf_screen_worst_error_over_margin': worst})
    assert bad == 0 and worst <= 0.5, (bad, worst)

    lam_ln = lognormal_lam(256, 1000.0, 7)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(3)
    lam_mix = torch.rand((256,) * 3, generator=gen, device='cuda') * 50
    lam_mix.view(-1)[::97] = 0
    poisson_case(key, 'lognormal 256^3', lam_ln)
    assert float(lam_ln.max()) < 10, "the lognormal lam left Knuth's range"
    poisson_case(key, 'uniform [0, 50] with zeros 256^3', lam_mix)

    n = 2 ** 20 + 3
    edge = torch.rand(n, generator=gen, device='cuda') * 30
    specials = ((97, 0.0), (89, -1e-3), (83, -5.0), (101, float('nan')),
                (1009, float('inf')), (1013, float('-inf')), (103, 1e-40),
                (107, 10.0), (109, float(np.nextafter(np.float32(10),
                                                      np.float32(0)))))
    for step, value in specials:
        edge[step // 2::step] = value
    poisson_case(key, 'zeros, negatives, NaN, +-inf, 10 and its '
                 'neighbour, n = 2^20 + 3', edge)

    flat = lam_mix.view(-1)
    for off in (1, 2, 3):
        poisson_case(key, 'view at +%d cells, n = 2^20 + 5' % off,
                     flat[off:off + 2 ** 20 + 5])
    for m in (1, 2, 3, 5, 4095, 4097, 12291):
        poisson_case(key, 'view at +3 cells, n = %d' % m, flat[3:3 + m])

    # lam = -logf(u0) of each cell's own first uniform, and its two
    # neighbours: the stop decision of Knuth's first step on its boundary
    m = 2 ** 22
    knuth_tab, _ = tf.poisson_tables(key)
    u0 = tf.threefry_fill_cuda(knuth_tab[0], 0, m, 'uniform32',
                               device='cuda')
    base = -torch.log(u0)
    del u0
    lam_b = base.clone()
    lam_b[1::3] = torch.nextafter(base, torch.full_like(base,
                                                       float('inf')))[1::3]
    lam_b[2::3] = torch.nextafter(base, torch.zeros_like(base))[2::3]
    del base
    counts, _ = poisson_case(key, 'Knuth stop boundary 2^22', lam_b)
    knuth = lam_b < 10
    for r, stops in ((0, True), (1, False), (2, True)):
        sel = knuth[r::3]
        stopped = counts[r::3][sel] == 0
        assert bool(stopped.all() if stops else (~stopped).all()), \
            "boundary cells %d::3 did not %s" % (r, 'stop' if stops
                                                 else 'go on')
    del lam_b, counts, knuth

    # a list sized for expected = 0 holds the floor of 1024 entries
    _, sc = poisson_case(key, 'uniform [0, 50] with zeros 256^3, list '
                         'sized for expected = 0', lam_mix, expected=0.0)
    assert sc['runs'] == 2 and sc['capacity'] > 1024, sc

    # a cell that runs past a subkey table sets the kernel's flag, and
    # the wrapper raises: Knuth cells past 2 draws, rejection cells past
    # 1 iteration
    for name in ('KNUTH_TABLE', 'REJECTION_TABLE'):
        for fn, args in ((tf.poisson_threefry_cuda, ()),
                         (tf.poisson_cells_cuda, (float(lam_mix.sum()),))):
            saved = getattr(tf, name)
            setattr(tf, name, 2 if name == 'KNUTH_TABLE' else 1)
            try:
                fn(key, lam_mix, *args)
            except tf.PoissonTableExhausted:
                pass
            else:
                raise AssertionError("%s overflow was not reported by %s"
                                     % (name, fn.__name__))
            finally:
                setattr(tf, name, saved)
    emit({'phase': 'rng_check', 'kernel': 'poisson_threefry',
          'table_overflow_raises': ['KNUTH_TABLE', 'REJECTION_TABLE'],
          'modes': ['full_mesh', 'occupied_cells']})


def lognormal_lam(nmesh, box, seed):
    """lam of a lognormal mock at the lognormal path's density and bias
    (the first steps of LogNormalCatalog): the Poisson kernel's input."""
    from nbodykit_tpu_torch import mockmaker
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    pm = ParticleMesh(nmesh, box, dtype='f4')
    delta_k, _ = mockmaker.gaussian_complex_fields(pm, linear_power(), seed)
    delta = pm.c2r(delta_k.value)
    del delta_k
    return mockmaker.lognormal_lambda(delta, pm, LN_N / LN_BOX ** 3,
                                      LN_BIAS)


def sass_hash_ops():
    """(integer instructions of one threefry2x32 hash, their opcodes) in
    the built library's SASS (``cuobjdump -sass``): the grid-stride loop
    body of the bits32 fill kernel, less what is not the hash: the store,
    the branch, the compares, the address arithmetic, the 64-bit adds of
    the counter and the loop index (IADD3 with a carry out, IADD3.X with
    a carry in) and the one xor of the two hash words."""
    from nbodykit_tpu_torch import _build
    tool = shutil.which('cuobjdump') or os.path.join(
        os.path.dirname(_build.nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', _build._target('threefry')[1]],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    fn = sass.split('Function : _Z20threefry_fill_kernelILi0E')[1]
    fn = fn.split('Function :')[0]
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', fn)]
    end, top = next((a, int(t.split()[-1], 16)) for a, t in ins
                    if re.match(r'@!?P\d BRA 0x', t)
                    and int(t.split()[-1], 16) < a)
    ops = {}
    for a, t in ins:
        if not top <= a <= end:
            continue
        op = t.split()[0]
        if op.startswith('@'):
            op = t.split()[1]
        carry = op.startswith('IADD3') and re.search(r'\bP[0-6]\b', t)
        if carry or op.startswith(('STG', 'BRA', 'ISETP', 'LEA')):
            continue
        ops[op] = ops.get(op, 0) + 1
    ops['LOP3.LUT'] -= 1                       # the output's h1 ^ h2
    return sum(ops.values()), ops


def hash_clocks(opcodes):
    """(clocks per threefry hash per SM, the limit): the busiest of the
    ALU pipe, the FMA pipe and the issue slots for the hash's SASS
    instruction mix ``opcodes``."""
    alu = sum(v for k, v in opcodes.items() if k.startswith(ALU_OPCODES))
    fma = sum(v for k, v in opcodes.items() if k.startswith(FMA_OPCODES))
    return max((alu / PIPE_PER_CLOCK_PER_SM, 'alu_pipe'),
               (fma / PIPE_PER_CLOCK_PER_SM, 'fma_pipe'),
               (sum(opcodes.values()) / ISSUE_PER_CLOCK_PER_SM, 'issue'))


def threefry_bound(nbytes, hashes, opcodes):
    """(ms, by) of a threefry kernel: bytes at the HBM rate, or the
    hashes at :func:`hash_clocks` clocks per hash on every SM at the
    boost clock."""
    mhz, sms = sm_clock()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = hashes * hash_clocks(opcodes)[0] / (sms * mhz * 1e6) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_threefry(n, opcodes):
    """threefry_fill at the white noise's shape (normal f32, n = Nmesh^3
    of the lognormal path): kernel, plain version, and both compared."""
    from nbodykit_tpu_torch import rng
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    key = rng.key(LN_SEED)

    def launch():
        return tf.threefry_fill_cuda(key, 0, n, 'normal32', device='cuda')
    ms = cuda_ms(launch, reps=5)
    a = launch()
    b, plain_ms = timed(lambda: tf.threefry_fill_plain(
        key, 0, n, 'normal32', device='cuda'))
    nd, ulp = _same(a, b)
    err = float((a - b).abs().max())
    assert nd == 0, "white noise draw: %d of %d differ" % (nd, n)
    del a, b
    b_ms, b_by = threefry_bound(4 * n, n, opcodes)
    mhz, sms = sm_clock()
    clocks, limit = hash_clocks(opcodes)
    emit({'phase': 'threefry_timing', 'n': n, 'kind': 'normal32',
          'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
          'hash_opcodes': opcodes, 'hash_clocks_per_sm': clocks,
          'hash_limit': limit, 'clocks_max_sm_mhz': mhz, 'sms': sms})
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err,
                at='normal f32 n=%d (the %d^3 white noise)' % (n, LN_NMESH))


def time_poisson(lam, opcodes, expected):
    """poisson_threefry at the lognormal path's lam in both modes: the
    kernel's times, the plain versions' times, the full-mesh counts
    against the plain counts and the occupied cells against their
    nonzero(); bounds from this lam's bytes and hashes."""
    from nbodykit_tpu_torch import rng
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    key = rng.split(rng.key(LN_SEED))[0]
    n = lam.numel()
    sf, sc = {}, {}
    full_ms = cuda_ms(lambda: tf.poisson_threefry_cuda(key, lam, stats=sf),
                      reps=5)
    cells_ms = cuda_ms(lambda: tf.poisson_cells_cuda(key, lam, expected,
                                                     stats=sc), reps=5)
    a = tf.poisson_threefry_cuda(key, lam)
    b, full_plain_ms = timed(lambda: tf.poisson_threefry_plain(key, lam))
    nd = int((a != b).sum())
    err = int((a - b).abs().max())
    assert nd == 0, "poisson at the lognormal path: %d cells differ" % nd
    del a
    flat = b.reshape(-1)
    ref = torch.nonzero(flat).reshape(-1)
    ref_counts, ref_N = flat[ref], int(flat.sum())
    del b, flat
    ids, cnts, N = tf.poisson_cells_cuda(key, lam, expected)
    same = bool(torch.equal(ids, ref) and torch.equal(cnts, ref_counts)
                and N == ref_N)
    assert same, "occupied cells at the lognormal path differ"
    occupied = ids.numel()
    del ids, cnts, ref, ref_counts
    torch.cuda.empty_cache()
    _, cells_plain_ms = timed(lambda: tf.poisson_cells_plain(key, lam))
    torch.cuda.empty_cache()
    full_bound = threefry_bound(12 * n, sf['hashes'], opcodes)
    cells_bound = threefry_bound(4 * n + 16 * occupied, sc['hashes'],
                                 opcodes)
    assert sf['hashes'] == sc['hashes'], (sf, sc)
    at = 'f32 lam %d^3, %d hashes' % (LN_NMESH, sc['hashes'])
    modes = {
        'full_mesh': dict(ms=full_ms, plain_ms=full_plain_ms,
                          library_ms=None, bound_ms=full_bound[0],
                          bound_by=full_bound[1], max_abs_err=err,
                          share_of_bound=full_bound[0] / full_ms,
                          at=at + ' -> int64 counts'),
        'occupied_cells': dict(ms=cells_ms, plain_ms=cells_plain_ms,
                               library_ms=None, bound_ms=cells_bound[0],
                               bound_by=cells_bound[1], max_abs_err=0,
                               share_of_bound=cells_bound[0] / cells_ms,
                               at=at + ' -> %d occupied cells' % occupied)}
    emit({'phase': 'poisson_timing', 'cells': n, 'occupied': occupied,
          'N': N, 'hashes': sc['hashes'],
          'hashes_per_cell': sc['hashes'] / n, 'capacity': sc['capacity'],
          'launches_per_call': sc['runs'],
          'lam_mean': float(lam.double().mean()),
          'lam_max': float(lam.max()), 'modes': modes})
    return modes


def linear_power():
    from nbodykit_tpu_torch import cosmology
    return cosmology.LinearPower(cosmology.Planck15, 0.55, 'EisensteinHu')


def check_linear_mesh():
    """LinearMesh at BoxSize 5000 / Nmesh 1024 with unitary amplitude:
    |delta_k|^2 V is P(|k|) mode by mode, so each FFTPower bin must be
    the mean of P(|k|) over its modes, binned by the same
    project_to_basis; 1e-4 relative below k_Nyquist."""
    from nbodykit_tpu_torch.algorithms.fftpower import (FFTPower,
                                                        project_to_basis)
    from nbodykit_tpu_torch.base.mesh import Field
    from nbodykit_tpu_torch.source.mesh import LinearMesh
    plin = linear_power()
    mesh = LinearMesh(plin, BoxSize=LN_BOX, Nmesh=LN_NMESH, seed=LN_SEED,
                      unitary_amplitude=True)
    r, ms = timed(lambda: FFTPower(mesh, mode='1d'))
    pm = mesh.pm
    kx, ky, kz = pm.k_list()
    expect = torch.empty(pm.shape_complex, dtype=torch.complex128,
                         device='cuda')
    for a in range(0, ky.shape[0], 64):
        k2 = kx ** 2 + ky[a:a + 64] ** 2 + kz ** 2
        expect[a:a + 64] = plin(torch.sqrt(k2)).to(torch.complex128)
    expect[0, 0, 0] = 0
    edges = [np.asarray(r.power.edges['k']), np.array([-1.0, 1.0])]
    (_, _, pe, ne), _ = project_to_basis(Field(expect, pm, 'complex'),
                                         edges)
    del expect
    P, modes, k = (r.power['power'].real, r.power['modes'],
                   r.power['k'])
    pe, ne = np.squeeze(pe).real, np.squeeze(ne)
    knyq = np.pi * LN_NMESH / LN_BOX
    sel = (modes > 0) & (k > 0) & (k < knyq)     # not the DC-only bin
    assert np.array_equal(ne, modes)
    rel = np.abs(P[sel] / pe[sel] - 1)
    emit({'phase': 'linear_mesh', 'nmesh': LN_NMESH, 'box': LN_BOX,
          'fftpower_ms': ms, 'bins_checked': int(sel.sum()),
          'max_rel_err': float(rel.max()), 'tol': 1e-4})
    assert np.isfinite(P[sel]).all() and rel.max() <= 1e-4, rel.max()


def lognormal_catalog():
    from nbodykit_tpu_torch.source.catalog import LogNormalCatalog
    return LogNormalCatalog(linear_power(), nbar=LN_N / LN_BOX ** 3,
                            BoxSize=LN_BOX, Nmesh=LN_NMESH, bias=LN_BIAS,
                            seed=LN_SEED)


def lognormal_fftpower(cat):
    """The benchmark's algorithm on the catalog: its compensated CIC
    mesh in f32, as the benchmark paints on the TPU (FFTPower on the
    catalog itself paints f64, as the JAX package does under x64)."""
    from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
    mesh = cat.to_mesh(Nmesh=LN_NMESH, resampler='cic', compensated=True)
    return mesh, FFTPower(mesh, mode='2d', kmin=0.001, Nmu=10)


def lognormal_path():
    """The benchmark flow at full width: Data (LogNormalCatalog) and
    Algorithm (FFTPower) once with every kernel's launches counted; the
    physics gates on the result; the mxu paint against the index_add_
    paint, and the deposit kernel against its plain version on the
    catalog's own payload (cluster branch, radix bucketing equal to
    argsort's); then one warm-up and LN_REPS timed calls of each."""
    from nbodykit_tpu_torch import set_options
    with counted_launches() as launches:
        torch.cuda.reset_peak_memory_stats()
        cat = lognormal_catalog()
        torch.cuda.synchronize()
        peak_data = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh, r = lognormal_fftpower(cat)
        torch.cuda.synchronize()
        peak_alg = torch.cuda.max_memory_allocated()
    # every kernel, the Poisson draw in its occupied-cells mode: the full
    # count mesh is not made on this path
    for k, v in launches.items():
        assert v >= 1 or k == 'poisson_threefry' or k in FOF_KERNELS, \
            "%s was not launched on the lognormal path" % k
    assert launches['poisson_threefry'] == 0, launches

    # gates: N, the painted mean, the large-scale bias
    nbar = LN_N / LN_BOX ** 3
    nexp = nbar * LN_BOX ** 3
    N = len(cat)
    assert abs(N - nexp) <= 5 * np.sqrt(nexp), (N, nexp)
    field = mesh.to_real_field()
    mean = float(field.value.double().mean())
    assert abs(mean - 1) <= 1e-5, "painted field mean %r" % mean
    with set_options(paint_method='scatter'):
        plain = mesh.to_real_field()
    diff = float((plain.value - field.value).abs().max())
    fmax = float(field.value.abs().max())
    del plain, field
    assert diff <= 1e-5 * fmax, \
        "mxu paint vs index_add_ paint: %g > 1e-5 * %g" % (diff, fmax)
    P, modes, k = (r.power['power'].real, r.power['modes'],
                   r.power['k'])
    sel = (modes > 0) & (k > 0.005) & (k < 0.03)
    plin = linear_power()
    ratio = float(np.sum(modes[sel] * (P[sel] - 1.0 / nbar))
                  / np.sum(modes[sel] * LN_BIAS ** 2 * plin(k[sel])))
    assert np.isfinite(P[modes > 0]).all()
    assert 0.85 <= ratio <= 1.15, "large-scale bias ratio %r" % ratio
    del mesh, r
    torch.cuda.empty_cache()

    full = (LN_NMESH,) * 3
    pos = cat['Position'] * (LN_NMESH / LN_BOX)
    plan, _, _, _, dplan = deposit_case(
        'cic %d^3 lognormal n=%d' % (LN_NMESH, N), pos,
        torch.ones(N, dtype=torch.float32, device='cuda'), full, full, 0,
        'cic', check_order=True)
    del pos
    assert dplan['nz'] > 1, "the 1024^3 deposit did not take the cluster " \
        "branch"
    torch.cuda.empty_cache()

    def data():
        return lognormal_catalog()

    def algorithm():
        return lognormal_fftpower(cat)
    data()
    _, t_data = spread(data, LN_REPS)
    algorithm()
    _, t_alg = spread(algorithm, LN_REPS)
    emit({'phase': 'lognormal_path', 'nmesh': LN_NMESH, 'box': LN_BOX,
          'nbar': nbar, 'N': N, 'N_expected': nexp,
          'N_gate': 5 * np.sqrt(nexp), 'field_mean': mean,
          'mxu_vs_scatter_max_abs': diff, 'field_max': fmax,
          'bias_ratio_0.005_0.03': ratio, 'bias_gate': [0.85, 1.15],
          'bins_in_bias_ratio': int(sel.sum()),
          'modes_in_bias_ratio': int(modes[sel].sum()),
          'peak_gb_data': peak_data / 1e9,
          'peak_gb_algorithm': peak_alg / 1e9,
          'deposit_plan': {'nz': dplan['nz'], 'zc': dplan['zc'],
                           'M': (plan['rb'] + 1) * (plan['cb'] + 1),
                           'smem_bytes': dplan['smem_bytes']},
          'launches': launches, 'reps': LN_REPS,
          'data_ms': t_data, 'algorithm_ms': t_alg})
    return cat, launches, lambda: lognormal_fftpower(data())


class StageTimes(object):
    """``utils.stage_timer``: one CUDA-event window per stage,
    the stream drained before and after it."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        b.synchronize()
        self.ms.setdefault(name, []).append(a.elapsed_time(b))


def lognormal_stages(cat):
    """The lognormal path's stages: LN_REPS LogNormalCatalog builds with
    ``utils.stage_timer`` set, so each stage of the real build is
    one CUDA-event window, and LN_REPS runs of the Algorithm's steps
    (paint, r2c, 3-D power, binning), one window each."""
    from nbodykit_tpu_torch import utils
    from nbodykit_tpu_torch.algorithms.fftpower import (FFTPower,
                                                        project_to_basis)
    times = StageTimes()
    utils.stage_timer = times
    try:
        for _ in range(LN_REPS):
            lognormal_catalog()
    finally:
        utils.stage_timer = None

    def step(name, fn):
        with times(name):
            return fn()
    mesh = cat.to_mesh(Nmesh=LN_NMESH, resampler='cic', compensated=True)
    for _ in range(LN_REPS):
        field = step('paint', lambda: mesh.to_real_field())
        step('r2c', lambda: field.r2c())
        del field
    r = FFTPower(mesh, mode='2d', kmin=0.001, Nmu=10)
    edges = [np.asarray(r.power.edges['k']), np.linspace(-1, 1, 11)]
    for _ in range(LN_REPS):
        y3d = step('power3d', lambda: r._compute_3d_power(r.first,
                                                          r.second)[0])
        step('binning', lambda: project_to_basis(y3d, edges))
        del y3d
    summary = {k: {'median': float(np.median(v)), 'min': min(v),
                   'max': max(v)} for k, v in times.ms.items()}
    emit({'phase': 'lognormal_stages', 'reps': LN_REPS, 'ms': summary})


# the CLASS path: the lognormal flow with the default (CLASS) LinearPower;
# the native solver's checks at the k values and tolerances of
# tests/test_boltzmann_native.py; one fresh solve, Planck15 at h = 0.7,
# whose sigma8 the native solve gives on the CPU
CLASS_KS = (1e-4, 0.05, 0.6)
CLASS_RTOL = {'phi': 2e-4, 'psi': 2e-4, 'd_cdm': 2e-4, 'd_b': 2e-4,
              't_b': 2e-4, 'd_ncdm': 3e-3}
CLASS_FRESH_SIGMA8 = 0.84576084112253
# draws of the choice checks, and how many of them the CPU repeats
CHOICE_N, CHOICE_CPU_N, CHOICE_K = 10 ** 7, 10 ** 6, 1000


def class_linear_power():
    from nbodykit_tpu_torch import cosmology
    return cosmology.LinearPower(cosmology.Planck15, 0.55)


def class_catalog():
    """The benchmark's Data phase with the default transfer: the CLASS
    LinearPower (Planck15's shipped table), then the LogNormalCatalog."""
    from nbodykit_tpu_torch.source.catalog import LogNormalCatalog
    return LogNormalCatalog(class_linear_power(), nbar=LN_N / LN_BOX ** 3,
                            BoxSize=LN_BOX, Nmesh=LN_NMESH, bias=LN_BIAS,
                            seed=LN_SEED)


def class_engine_checks():
    """The Boltzmann library's build, the native solve against the
    scipy BDF path, Planck15 from its shipped table, and one fresh
    solve into a temporary cache."""
    import tempfile
    from nbodykit_tpu_torch import _build
    from nbodykit_tpu_torch import cosmology
    from nbodykit_tpu_torch.cosmology import boltzmann

    lib = 'boltzmann_kernel'
    t0 = time.perf_counter()
    built = bool(_build.build_all([lib]))
    build_s = time.perf_counter() - t0 if built else None
    _build.load_host(lib)
    emit({'phase': 'class_build', 'library': lib, 'compiler': 'g++',
          'flags': _build.HOST_FLAGS, 'built_here': built,
          'build_s': build_s})

    c = cosmology.Planck15
    lna = np.sort(np.log(1.0 / (1.0 + np.array([9.0, 1.0, 0.0]))))
    nat = boltzmann.BoltzmannSolver(c._bg, c._th)
    py = boltzmann.BoltzmannSolver(c._bg, c._th, use_native=False)
    modes = []
    for k in CLASS_KS:
        a, t_nat = timed_host(lambda: nat.solve_mode(k, lna))
        b, t_py = timed_host(lambda: py.solve_mode(k, lna))
        err = {q: float(np.max(np.abs(a[q] / b[q] - 1))) for q in CLASS_RTOL}
        modes.append({'k': k, 'native_ms': t_nat, 'python_ms': t_py,
                      'max_rel_err': err})
        for q, tol in CLASS_RTOL.items():
            assert err[q] <= tol, (k, q, err[q], tol)
    emit({'phase': 'class_native', 'cosmology': 'Planck15', 'z': [9, 1, 0],
          'rtol': CLASS_RTOL, 'modes': modes})

    real = boltzmann.BoltzmannSolver

    def refuse(*args, **kwargs):
        raise AssertionError("Planck15 started a solve")
    boltzmann.BoltzmannSolver = refuse
    try:
        shipped = c.clone()
        s8, t_ship = timed_host(lambda: shipped.sigma8)
    finally:
        boltzmann.BoltzmannSolver = real
    assert shipped.engine.source == 'shipped', shipped.engine.source
    emit({'phase': 'class_shipped', 'cosmology': 'Planck15',
          'key': shipped.engine._key(), 'source': shipped.engine.source,
          'solvers_built': 0, 'sigma8': s8, 'host_ms': t_ship})

    old = os.environ.get('NBKIT_TORCH_CLASS_CACHE')
    with tempfile.TemporaryDirectory() as d:
        os.environ['NBKIT_TORCH_CLASS_CACHE'] = d
        try:
            fresh = c.clone(h=0.7)
            s8, t_fresh = timed_host(lambda: fresh.sigma8)
            written = os.listdir(d)
        finally:
            if old is None:
                del os.environ['NBKIT_TORCH_CLASS_CACHE']
            else:
                os.environ['NBKIT_TORCH_CLASS_CACHE'] = old
    rel = abs(s8 / CLASS_FRESH_SIGMA8 - 1)
    emit({'phase': 'class_fresh', 'cosmology': 'Planck15.clone(h=0.7)',
          'source': fresh.engine.source,
          'k_modes': int(len(fresh.engine._tables['k'])),
          'host_s': t_fresh / 1e3, 'sigma8': s8,
          'sigma8_cpu': CLASS_FRESH_SIGMA8, 'rel_err': rel, 'tol': 1e-6,
          'cache_files': written})
    assert fresh.engine.source == 'solved' and rel <= 1e-6, (s8, rel)
    assert written == [fresh.engine._key() + '.npz'], written


def timed_host(fn):
    """(result, host ms) of one call of ``fn``, the card drained before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def class_flow():
    """The lognormal benchmark flow with the CLASS LinearPower at full
    size: Data and Algorithm once with every kernel's launches counted,
    the lognormal gates, then one warm-up and LN_REPS timed calls of
    each."""
    with counted_launches() as launches:
        torch.cuda.reset_peak_memory_stats()
        cat = class_catalog()
        torch.cuda.synchronize()
        peak_data = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh, r = lognormal_fftpower(cat)
        torch.cuda.synchronize()
        peak_alg = torch.cuda.max_memory_allocated()
    for k in ('threefry_fill', 'poisson_cells', 'paint_deposit',
              'radix_rank'):
        assert launches[k] >= 1, "%s was not launched on the CLASS path" % k
    assert launches['poisson_threefry'] == 0, launches

    nbar = LN_N / LN_BOX ** 3
    nexp = nbar * LN_BOX ** 3
    N = len(cat)
    assert abs(N - nexp) <= 5 * np.sqrt(nexp), (N, nexp)
    P, modes, k = (r.power['power'].real, r.power['modes'],
                   r.power['k'])
    sel = (modes > 0) & (k > 0.005) & (k < 0.03)
    plin = class_linear_power()
    assert plin.transfer == 'CLASS'
    ratio = float(np.sum(modes[sel] * (P[sel] - 1.0 / nbar))
                  / np.sum(modes[sel] * LN_BIAS ** 2 * plin(k[sel])))
    assert np.isfinite(P[modes > 0]).all()
    assert 0.85 <= ratio <= 1.15, "large-scale bias ratio %r" % ratio
    del r
    class_catalog()
    _, t_data = spread(class_catalog, LN_REPS)
    lognormal_fftpower(cat)
    _, t_alg = spread(lambda: lognormal_fftpower(cat), LN_REPS)
    emit({'phase': 'class_flow', 'transfer': plin.transfer,
          'sigma8': plin.sigma8, 'nmesh': LN_NMESH, 'box': LN_BOX,
          'nbar': nbar, 'N': N, 'N_expected': nexp,
          'N_gate': 5 * np.sqrt(nexp),
          'bias_ratio_0.005_0.03': ratio, 'bias_gate': [0.85, 1.15],
          'peak_gb_data': peak_data / 1e9,
          'peak_gb_algorithm': peak_alg / 1e9,
          'launches': {n: launches[n] for n in (
              'threefry_fill', 'poisson_threefry', 'poisson_cells',
              'paint_deposit', 'radix_rank')},
          'reps': LN_REPS, 'data_ms': t_data, 'algorithm_ms': t_alg})
    return cat, mesh, launches


def peak_of(fn):
    """(result, {median, min, max} CUDA-event ms, peak GB allocated):
    one warm-up call, then LN_REPS timed calls, each with the previous
    result freed; the peak is the last call's."""
    fn()
    ts = []
    for _ in range(LN_REPS):
        out = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, t = timed(fn)
        ts.append(t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    return out, {'median': float(np.median(ts)), 'min': min(ts),
                 'max': max(ts)}, peak


def p0_of(field, kedges):
    """(P0, modes) of a complex field in the bins ``kedges``: |delta_k|^2
    V with the DC mode cleared, binned by ``project_to_basis`` as FFTPower
    bins it, with no transform on the way."""
    from nbodykit_tpu_torch.algorithms.fftpower import project_to_basis
    from nbodykit_tpu_torch.base.mesh import Field
    v = field.value
    p3d = (v * v.conj()).to(torch.complex128) \
        * float(np.prod(field.pm.BoxSize))
    p3d[0, 0, 0] = 0
    (_, _, P, N), _ = project_to_basis(Field(p3d, field.pm, 'complex'),
                                       [kedges, np.array([-1.0, 1.0])])
    return np.squeeze(P).real, np.squeeze(N)


def class_resample(mesh):
    """The flow's 1024^3 mesh resampled down (the whole compute, then
    the resample alone on its complex field; P0 below half the 512^3
    Nyquist equal to the 1024^3 one: the modes are copied unscaled), a
    512^3 mesh resampled up (the same two timings), and a 256^3 preview
    against the sum of the 256^3 field (at LN_NMESH = 1024)."""
    from nbodykit_tpu_torch.base.mesh import FieldMesh
    half, quarter = LN_NMESH // 2, LN_NMESH // 4
    _, t_whole, pk_whole = peak_of(
        lambda: mesh.compute(mode='complex', Nmesh=half))
    torch.cuda.empty_cache()
    big = mesh.compute(mode='complex')
    small, t_down, pk_down = peak_of(lambda: mesh._resample(big, half))
    kedges = np.arange(0.0, 0.5 * np.pi * half / LN_BOX, 0.005)
    pb, nb = p0_of(big, kedges)
    del big
    torch.cuda.empty_cache()
    ps, ns = p0_of(small, kedges)
    ok = nb > 0
    rel = float(np.max(np.abs(ps[ok] - pb[ok])
                       / np.maximum(np.abs(pb[ok]), 1e-300)))
    assert np.array_equal(ns, nb) and rel <= 1e-6, rel

    small_mesh = FieldMesh(small)
    up, t_up, pk_up = peak_of(lambda: small_mesh._resample(small, LN_NMESH))
    assert tuple(up.value.shape) == (LN_NMESH, LN_NMESH, LN_NMESH // 2 + 1)
    del up
    torch.cuda.empty_cache()
    up, t_up_whole, pk_up_whole = peak_of(
        lambda: small_mesh.compute(mode='complex', Nmesh=LN_NMESH))
    del up, small, small_mesh
    torch.cuda.empty_cache()

    pv, t_pv, pk_pv = peak_of(
        lambda: mesh.preview(axes=[0, 1], Nmesh=quarter))
    fq = mesh.compute(mode='real', Nmesh=quarter)
    total = float(fq.value.double().sum())
    prel = abs(float(pv.astype('f8').sum()) / total - 1)
    assert pv.shape == (quarter, quarter) and prel <= 1e-5, (pv.shape,
                                                             prel)
    del fq
    torch.cuda.empty_cache()
    emit({'phase': 'class_resample', 'down': {
              'from': LN_NMESH, 'to': half, 'resample_ms': t_down,
              'resample_peak_gb': pk_down, 'compute_ms': t_whole,
              'compute_peak_gb': pk_whole, 'bins_checked': int(ok.sum()),
              'p0_max_rel_err': rel, 'tol': 1e-6},
          'up': {'from': half, 'to': LN_NMESH, 'resample_ms': t_up,
                 'resample_peak_gb': pk_up, 'compute_ms': t_up_whole,
                 'compute_peak_gb': pk_up_whole},
          'preview': {'nmesh': quarter, 'axes': [0, 1], 'ms': t_pv,
                      'peak_gb': pk_pv, 'total_rel_err': prel,
                      'tol': 1e-5}})


def class_sort(cat):
    """CatalogSource.sort on the flow's catalog by a scalar column, both
    ways: ordered, and a permutation of the input."""
    cat['x'] = cat['Position'][:, 0]
    recs = {}
    for reverse in (False, True):
        def run():
            return cat.sort('x', reverse=reverse)
        run()
        out, t = spread(run, LN_REPS)
        x, idx = out['x'], out['Index']
        d = x[1:] - x[:-1]
        assert bool((d <= 0).all() if reverse else (d >= 0).all())
        assert bool((torch.bincount(idx, minlength=len(cat)) == 1).all())
        assert torch.equal(x, cat['x'][idx])
        recs['reverse' if reverse else 'forward'] = t
        del out, x, idx, d
    columns = cat.columns
    del cat['x']
    emit({'phase': 'class_sort', 'N': len(cat), 'key': 'Position[:, 0]',
          'columns': columns, 'ms': recs})


def class_choice():
    """DistributedRNG.choice at CHOICE_N draws on the card, with and
    without p; the first CHOICE_CPU_N equal the CPU's draws bit for
    bit."""
    from nbodykit_tpu_torch.rng import DistributedRNG
    p = np.random.RandomState(LN_SEED).dirichlet(np.ones(CHOICE_K))
    recs = {}
    for label, kw in (('uniform', {}), ('p', {'p': p})):
        def run():
            return DistributedRNG(LN_SEED, CHOICE_N).choice(CHOICE_K, **kw)
        run()
        out, t = spread(run, LN_REPS)
        cpu = DistributedRNG(LN_SEED, CHOICE_CPU_N, device='cpu').choice(
            CHOICE_K, **kw)
        assert out.shape == (CHOICE_N,) and out.dtype == torch.int64
        assert int(out.min()) >= 0 and int(out.max()) < CHOICE_K
        assert torch.equal(out[:CHOICE_CPU_N].cpu(), cpu), label
        recs[label] = dict(t, mean=float(out.double().mean()))
    emit({'phase': 'class_choice', 'draws': CHOICE_N, 'choices': CHOICE_K,
          'cpu_equal_draws': CHOICE_CPU_N, 'ms': recs})


def class_host(cat):
    """The host-side spectra at Planck15, z = 0.55, and LinearNbody on
    the flow's particles on the card."""
    from nbodykit_tpu_torch import cosmology
    c, z = cosmology.Planck15, 0.55
    k = np.logspace(-3, 1, 200)
    r = np.linspace(1.0, 200.0, 200)
    hf, t_hf = timed_host(lambda: cosmology.HalofitPower(c, z)(k))
    zk = np.logspace(-3, 0, 20)
    zp, t_z = timed_host(lambda: cosmology.ZeldovichPower(c, z)(zk))
    cf, t_cf = timed_host(
        lambda: cosmology.CorrelationFunction(class_linear_power())(r))
    for v in (hf, zp, cf):
        assert np.isfinite(v).all()
    plin = class_linear_power()(k)
    assert (hf >= 0.9 * plin).all()        # halofit adds power
    nb = cosmology.LinearNbody(c)
    disp, vel = cat['Position'], cat['Velocity']

    def run():
        return nb.integrate(None, disp, vel, 1.0 / (1.0 + z), 1.0)
    run()
    (d2, v2), t_nb = spread(run, LN_REPS)
    assert d2.device == disp.device and torch.isfinite(d2).all()
    emit({'phase': 'class_host', 'halofit_host_ms': t_hf,
          'zeldovich_host_ms': t_z, 'zeldovich_k': len(zk),
          'correlation_host_ms': t_cf, 'linear_nbody_N': len(cat),
          'linear_nbody_ms': t_nb,
          'growth_ratio': float((d2[:1000].double()
                                 / disp[:1000].double()).mean())})


def class_path():
    """The CLASS slice on the card: the engine's checks, the flow at
    full size, then resampling, sort, choice and the host spectra on
    its outputs. Returns the flow's launch counts."""
    class_engine_checks()
    cat, mesh, launches = class_flow()
    class_resample(mesh)
    del mesh
    torch.cuda.empty_cache()
    class_sort(cat)
    torch.cuda.empty_cache()
    class_choice()
    class_host(cat)
    del cat
    torch.cuda.empty_cache()
    return launches


# the convpower path: benchmarks/test_convpower.py at desi_like, data and
# randoms (10 nbar) from seeds 42 and 84
CP_BOX, CP_NMESH, CP_N, CP_DK, CP_POLES = 5000.0, 1024, 1e7, 0.005, [0, 2, 4]


def convpower_data():
    """The benchmark's Data phase: the data and randoms UniformCatalogs,
    their NZ columns from numpy, the FKPCatalog and its TSC mesh in f8
    (the bounding box from the randoms). Each step is a stage of
    ``utils.stage_timer``."""
    from nbodykit_tpu_torch.algorithms.convpower import FKPCatalog
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    from nbodykit_tpu_torch.utils import stage
    nbar = CP_N / CP_BOX ** 3
    with stage('draws'):
        data = UniformCatalog(nbar=nbar, BoxSize=CP_BOX, seed=42)
        randoms = UniformCatalog(nbar=10 * nbar, BoxSize=CP_BOX, seed=84)
    with stage('nz_columns'):
        data['NZ'] = nbar * np.ones(data.size)
        randoms['NZ'] = nbar * np.ones(randoms.size)
    with stage('fkp_catalog_and_bbox'):
        return FKPCatalog(data, randoms).to_mesh(Nmesh=CP_NMESH,
                                                 resampler='tsc')


def convpower_algorithm(mesh):
    """The benchmark's Algorithm phase."""
    from nbodykit_tpu_torch.algorithms.convpower import ConvolvedFFTPower
    return ConvolvedFFTPower(mesh, poles=CP_POLES, dk=CP_DK)


def convpower_path():
    """The ConvolvedFFTPower benchmark flow at full width: Data and
    Algorithm once with every kernel's launches counted and the peak
    memory of each; the gates on the result (data and randoms are
    independent Poisson samples, so the field is noise: P0 at the shot
    noise, P2 and P4 at 0, where the exact TSC shot-noise compensation
    leaves the noise flat); then one warm-up and LN_REPS timed calls of
    each phase."""
    with counted_launches() as launches:
        torch.cuda.reset_peak_memory_stats()
        mesh = convpower_data()
        torch.cuda.synchronize()
        peak_data = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = convpower_algorithm(mesh)
        torch.cuda.synchronize()
        peak_alg = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
    # two paints: the deposit twice, two rank passes each (alphabet
    # 16513); four catalog draws
    assert launches['paint_deposit'] == 2, launches
    assert launches['radix_rank'] == 4, launches
    assert launches['threefry_fill'] >= 4, launches

    fkp = mesh.source
    Nd, Nr = len(fkp['data']), len(fkp['randoms'])
    alpha = r.attrs['alpha']
    assert abs(alpha / (Nd / Nr) - 1) <= 1e-3, (alpha, Nd, Nr)
    norms = r.attrs['data.norm'], r.attrs['randoms.norm']
    assert abs(norms[0] / norms[1] - 1) <= 0.01, norms
    poles = r.poles
    k, modes = poles['k'], poles['modes']
    nbins = len(poles['k'])
    assert nbins == len(np.arange(0, np.pi * CP_NMESH /
                                  mesh.attrs['BoxSize'].max()
                                  + CP_DK / 2, CP_DK)) - 1, nbins
    for ell in CP_POLES:
        assert np.isfinite(poles['power_%d' % ell][modes > 0]).all()
    shot = r.attrs['shotnoise']
    sel = (modes > 0) & (k > 0.02) & (k < 0.1)
    wts = modes[sel]
    ratio = {ell: float(np.sum(wts * poles['power_%d' % ell][sel].real)
                        / np.sum(wts) / shot) for ell in CP_POLES}
    assert abs(ratio[0] - 1) < 0.02, "P0/shotnoise = %r" % ratio[0]
    assert abs(ratio[2]) < 0.02 and abs(ratio[4]) < 0.02, ratio
    del r

    # the results are dropped as they come: a second catalog pair would
    # take 8 GB beside the Algorithm's peak
    convpower_data()
    t_data = spread(convpower_data, LN_REPS)[1]
    convpower_algorithm(mesh)
    t_alg = spread(lambda: convpower_algorithm(mesh), LN_REPS)[1]
    emit({'phase': 'convpower_1024', 'nmesh': CP_NMESH,
          'box': mesh.attrs['BoxSize'].tolist(),
          'box_center': mesh.attrs['BoxCenter'].tolist(),
          'N_data': Nd, 'N_randoms': Nr, 'alpha': alpha,
          'alpha_over_ratio_minus_1': alpha / (Nd / Nr) - 1,
          'norms': norms, 'shotnoise': shot, 'nbins_k': nbins,
          'bins_in_ratio': int(sel.sum()), 'modes_in_ratio': int(wts.sum()),
          'P_over_shot_mean_0.02_0.1': ratio,
          'peak_gb_data': peak_data / 1e9,
          'peak_gb_algorithm': peak_alg / 1e9,
          'peak_gb_reserved': reserved / 1e9,
          'launches': launches, 'reps': LN_REPS,
          'data_ms': t_data, 'algorithm_ms': t_alg})
    return mesh, launches


def convpower_kernels(mesh):
    """The kernels at the convpower path's shapes: the mxu paint of the
    data against the index_add_ paint; the deposit against its plain
    version on the data's whole payload and on 16 x-stripes of the
    randoms' (TSC, f8, the cluster branch), each bucketed by the radix
    passes and equal to argsort's bucketing; the deposit's times on both
    whole payloads (the plain version on the data's and on the 16
    stripes) and the rank pass's at the randoms' n and digit."""
    from nbodykit_tpu_torch import set_options
    full = (CP_NMESH,) * 3
    dmesh = mesh['data']
    a = dmesh.to_real_field(normalize=False).value
    with set_options(paint_method='scatter'):
        b = dmesh.to_real_field(normalize=False).value
    diff = float((a - b).abs().max())
    fmax = float(a.abs().max())
    del a, b
    emit({'phase': 'convpower_kernels', 'check': 'data paint mxu vs '
          'index_add_', 'max_abs': diff, 'field_max': fmax,
          'tol': 1e-5 * fmax})
    assert diff <= 1e-5 * fmax, (diff, fmax)

    recs = {}
    for name, stripes in (('data', None), ('randoms', 16)):
        sm = mesh[name]
        src = sm.source
        pos = src[sm.position] * torch.as_tensor(
            sm.pm.Nmesh / sm.pm.BoxSize, dtype=torch.float64, device='cuda')
        mass = src[sm.weight].to(torch.float64)
        plan, payload, geom, err, lplan = deposit_case(
            'tsc %d^3 f8 convpower %s n=%d' % (CP_NMESH, name, len(src)),
            pos, mass, full, full, 0, 'tsc', check_order=True,
            stripes=stripes)
        del pos, mass
        assert lplan['nz'] > 1, "the convpower deposit did not take " \
            "the cluster branch"
        recs[name] = time_deposit(payload, geom, plan, err,
                                  plain=stripes is None)
        if stripes:
            sub = tuple(a[:stripes].contiguous() for a in payload)
            recs['%s_%d_stripes' % (name, stripes)] = time_deposit(
                sub, geom, plan, err)
            del sub
        del payload
        torch.cuda.empty_cache()
    rank = time_rank(len(mesh.source['randoms']), D=129, plain_reps=1)
    emit({'phase': 'convpower_kernels', 'deposit': recs, 'rank': rank})
    return recs, rank


def convpower_stages(mesh):
    """LN_REPS runs of Data and Algorithm with ``utils.stage_timer``
    set: the draws, NZ columns, FKP catalog and bounding box; the data
    and randoms paints, each multipole's FFT loop (multipole_0: the two
    transforms of the density and their compensation) and every call of
    the binning."""
    from nbodykit_tpu_torch import utils
    times = StageTimes()
    utils.stage_timer = times
    try:
        for _ in range(LN_REPS):
            convpower_data()
            convpower_algorithm(mesh)
    finally:
        utils.stage_timer = None
    summary = {k: {'median': float(np.median(v)), 'min': min(v),
                   'max': max(v), 'windows': len(v)}
               for k, v in times.ms.items()}
    emit({'phase': 'convpower_stages', 'reps': LN_REPS, 'ms': summary})


def other_fft_algorithms(cat, nmesh):
    """FFTCorr(mode='1d') and ProjectedFFTPower(axes=(0, 1)) once on
    the main path's compensated CIC mesh. The catalog is uniform, so
    both see shot noise only, which the exact CIC shot-noise
    compensation leaves flat at 1/N per mode: xi(0) = (Nmesh^3 - 1) / N
    and xi = 0 elsewhere; the projected power at Lx Ly / N."""
    from nbodykit_tpu_torch.algorithms import FFTCorr, ProjectedFFTPower
    mesh = cat.to_mesh(Nmesh=nmesh, resampler='cic', compensated=True)
    N = len(cat)
    box = cat.attrs['BoxSize']
    xi, xi_ms = timed(lambda: FFTCorr(mesh, mode='1d'))
    corr = xi.corr['corr']
    xi0 = float(corr[0]) * N / (nmesh ** 3 - 1)
    xi_off = float(np.abs(corr[1:]).max())
    emit({'phase': 'fftcorr_512', 'ms': xi_ms, 'nbins': len(corr),
          'xi0_over_expected': xi0, 'max_abs_xi_r_gt_0': xi_off,
          'gates': {'xi0': 0.01, 'xi_r_gt_0': 0.01}})
    assert np.isfinite(corr).all()
    assert abs(xi0 - 1) < 0.01 and xi_off < 0.01, (xi0, xi_off)
    pp, pp_ms = timed(lambda: ProjectedFFTPower(mesh, axes=(0, 1)))
    P, modes = pp.power['power'].real, pp.power['modes']
    expect = float(box[0] * box[1]) / N
    ratio = float(np.sum(modes * P) / np.sum(modes) / expect)
    emit({'phase': 'projected_fftpower_512', 'ms': pp_ms,
          'nbins': len(P), 'modes': int(modes.sum()),
          'P_over_area_over_N': ratio, 'gate': 0.02})
    assert np.isfinite(P[modes > 0]).all()
    assert abs(ratio - 1) < 0.02, ratio

# the FOF path: benchmarks/test_fof.py at desi_like, on the lognormal
# path's catalog; then the FFTRecon path on that catalog with 10x
# uniform randoms (seed 84) at Nmesh 512
FOF_LL, FOF_NMIN, FOF_MASS = 0.2, 20, 1e12
RC_NMESH = 512


def fof_algorithm(cat):
    """The benchmark's Algorithm phase: FOF, its halos, and the halo
    positions on the host."""
    from nbodykit_tpu_torch.cosmology import Planck15
    from nbodykit_tpu_torch.lab import FOF
    fof = FOF(cat, linking_length=FOF_LL, nmin=FOF_NMIN)
    halos = fof.to_halos(FOF_MASS, Planck15, 0.0)
    return fof, halos, halos['Position'].cpu().numpy()


def fof_path():
    """The FOF benchmark flow at full width: Data (LogNormalCatalog) and
    Algorithm (FOF, to_halos, positions to the host) once with every
    kernel's launches counted and the peak memory of each; the gates;
    then one warm-up and LN_REPS timed calls of each phase."""
    with counted_launches() as data_launches:
        torch.cuda.reset_peak_memory_stats()
        cat = lognormal_catalog()
        torch.cuda.synchronize()
        peak_data = torch.cuda.max_memory_allocated()
    with counted_launches() as alg_launches:
        torch.cuda.reset_peak_memory_stats()
        fof, halos, hpos = fof_algorithm(cat)
        torch.cuda.synchronize()
        peak_alg = torch.cuda.max_memory_allocated()
    from nbodykit_tpu_torch.ops.radix import digit_plan
    launches = {k: data_launches[k] + alg_launches[k] for k in alg_launches}
    # the grid's LSD rank passes (4 at desi_like) and one sweep kernel per
    # sweep; the algorithm paints nothing
    ncell = int(np.floor(LN_BOX / fof._ll))
    passes = digit_plan(ncell ** 3 + 1)[0]
    assert alg_launches['radix_rank'] == passes, (alg_launches, passes)
    assert alg_launches['fof_sweep'] == fof.sweeps >= 1, \
        (alg_launches, fof.sweeps)
    # the flow's list fits: links mode, one link count and one fill
    assert fof.sweep_mode == 'links', (fof.sweep_mode, fof.links)
    assert alg_launches['fof_sweep_links'] == fof.sweeps, alg_launches
    assert alg_launches['fof_link_count'] == 1, alg_launches
    assert alg_launches['fof_link_fill'] == 1, alg_launches
    assert alg_launches['paint_deposit'] == 0, alg_launches

    # the halo columns
    N = len(cat)
    feats = fof.find_features()
    length = feats['Length']
    lh = length[1:]
    cm = feats['CMPosition'][1:]
    assert int(length.sum()) == N
    assert len(lh) == fof._halo_count == len(halos) >= 1
    assert bool((lh[1:] <= lh[:-1]).all()) and int(lh.min()) >= FOF_NMIN
    assert bool((cm >= 0).all()) and bool((cm < LN_BOX).all())
    assert np.isfinite(hpos).all() and hpos.shape == (len(halos), 3)
    assert torch.equal(halos['Mass'], lh.to(torch.float64) * FOF_MASS)
    cat_gate = fof_catalog_gate(cat, fof, feats)
    del feats

    sweep = fof_sweep_checks(cat, fof)
    from nbodykit_tpu_torch.hod import Zheng07Model
    galaxies = len(halos.populate(Zheng07Model, seed=42))

    def data():
        return lognormal_catalog()

    def algorithm():
        return fof_algorithm(cat)
    data()
    t_data = spread(data, LN_REPS)[1]
    algorithm()
    t_alg = spread(algorithm, LN_REPS)[1]
    emit({'phase': 'fof_1024', 'box': LN_BOX, 'N': N,
          'linking_length_abs': fof._ll, 'nmin': FOF_NMIN,
          'sweeps': fof.sweeps, 'sweep_mode': fof.sweep_mode,
          'links': fof.links, 'halos': len(halos),
          'largest_halo': int(lh[0]), 'smallest_halo': int(lh[-1]),
          'in_halos': int(lh.sum()), 'galaxies_zheng07_seed42': galaxies,
          'fof_catalog_vs_cpu': cat_gate,
          'peak_gb_data': peak_data / 1e9,
          'peak_gb_algorithm': peak_alg / 1e9,
          'launches': launches, 'launches_algorithm': alg_launches,
          'reps': LN_REPS, 'data_ms': t_data, 'algorithm_ms': t_alg})
    return cat, launches, sweep


def fof_catalog_gate(cat, fof, feats):
    """fof_catalog on the card against the same function on CPU copies:
    Length exactly; the halos' CMPosition (minimum image) and CMVelocity
    to 1e-5 of the column's largest magnitude (CUDA's index_add_ sums in
    another order than the CPU's). Label 0, the particles in no halo, is
    left out of the centre-of-mass check: it spans the box, and its f32
    sum of 1e7 offsets depends on the order."""
    from nbodykit_tpu_torch.algorithms.fof import fof_catalog
    from nbodykit_tpu_torch.source.catalog.array import ArrayCatalog
    src = ArrayCatalog({'Position': cat['Position'].cpu(),
                        'Velocity': cat['Velocity'].cpu()}, device='cpu')
    ref = fof_catalog(src, fof.labels.cpu(), fof._halo_count + 1,
                      fof.attrs['BoxSize'])
    assert torch.equal(ref['Length'], feats['Length'].cpu())
    d = (feats['CMPosition'][1:].cpu() - ref['CMPosition'][1:]).double()
    d = torch.minimum(d.abs(), LN_BOX - d.abs())
    pos_err = float(d.max())
    vel_err = float((feats['CMVelocity'][1:].cpu()
                     - ref['CMVelocity'][1:]).abs().max())
    vmax = float(ref['CMVelocity'][1:].abs().max())
    assert pos_err <= 1e-5 * LN_BOX, pos_err
    assert vel_err <= 1e-5 * vmax, (vel_err, vmax)
    return {'cm_position_max_abs': pos_err, 'cm_velocity_max_abs': vel_err,
            'cm_velocity_max': vmax, 'tol_rel': 1e-5}


def fof_mode_checks(label, pos, box, ll):
    """Both sweep modes on one catalog's grid: the link count and fill
    kernels against their plain versions; each mode's fixpoint (the
    search sweep kernel, or the links sweep kernel over the list, to no
    change) giving the labels and sweeps of ``fof_fixpoint`` (which must
    take the links mode) and the roots of an argsort-ordered run; the
    search and links sweep kernels against ``fof_sweep_plain`` at the
    first sweep and at the fixpoint, all bit for bit. Times: each kernel
    (CUDA events), its plain version (one call), each mode's fixpoint
    (events, and its kernels' device time from the profiler), beside the
    byte bounds. Returns {mode or kernel: record}."""
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    from nbodykit_tpu_torch.ops import devicehash as dh
    from nbodykit_tpu_torch.ops.devicehash import (DeviceGridHash,
                                                   fof_fixpoint,
                                                   local_fof_labels,
                                                   roots_in_slot_order,
                                                   sweep_to_fixpoint)
    t0 = time.perf_counter()
    n = pos.shape[0]
    grid = DeviceGridHash(pos, box, ll)
    cols = grid.columns()
    ci_s = grid.cell_of(grid.pos_s).contiguous()
    args = (grid.pos_s, ci_s, grid.flat_s, grid.valid_s)
    geo = grid.geometry(ll ** 2)
    pb, kb = pos.element_size(), grid.flat_s.element_size()

    # the link kernels against the plain link list
    counts = fc.fof_link_count_cuda(*args, cols, *geo)
    pc, count_plain_ms = timed(lambda: fc.fof_link_count_plain(*args, *geo))
    nd = int((counts != pc).sum())
    assert nd == 0, "%s: %d link counts differ" % (label, nd)
    row = torch.zeros(n + 1, dtype=torch.int64, device='cuda')
    torch.cumsum(counts, 0, out=row[1:])
    E = int(row[-1])
    links = fc.fof_link_fill_cuda(*args, cols, row, *geo, nlinks=E)
    pl, fill_plain_ms = timed(lambda: fc.fof_link_fill_plain(*args, row,
                                                             *geo))
    assert torch.equal(links, pl), "%s: the link lists differ" % label
    del pc, pl

    # each mode's fixpoint on its sweep kernel
    def links_mode():
        return sweep_to_fixpoint(
            lambda lab: fc.fof_links_sweep_cuda(row, links, lab), n,
            pos.device)

    def search_mode():
        return sweep_to_fixpoint(
            lambda lab: fc.fof_sweep_cuda(*args, lab, *geo, cols=cols), n,
            pos.device)
    st = {}
    fixlab, sweeps, _ = fof_fixpoint(grid, ll, stats=st)
    assert st == {'sweep_mode': 'links', 'links': E}, (label, st, E)
    roots = local_fof_labels(pos, None, box, ll, order='argsort')
    assert torch.equal(local_fof_labels(pos, None, box, ll), roots), label
    for mode, run in (('links', links_mode), ('search', search_mode)):
        lab, got = run()
        assert torch.equal(lab, fixlab) and got == sweeps, (label, mode,
                                                            got, sweeps)
        assert torch.equal(roots_in_slot_order(grid, lab), roots), \
            (label, mode)
    del roots

    count_ms = cuda_ms(lambda: fc.fof_link_count_cuda(*args, cols, *geo),
                       reps=5)
    fill_ms = cuda_ms(lambda: fc.fof_link_fill_cuda(*args, cols, row, *geo,
                                                    nlinks=E), reps=5)

    # the sweeps of both modes against the plain sweep
    lab0 = torch.arange(n, dtype=torch.int32, device='cuda')
    at = {}
    for name, lab in (('first_sweep', lab0), ('fixpoint', fixlab)):
        p, plain_ms = timed(lambda: fc.fof_sweep_plain(*args, lab, *geo))
        s = fc.fof_sweep_cuda(*args, lab, *geo, cols=cols)
        c = fc.fof_links_sweep_cuda(row, links, lab)
        pcsr, csr_plain_ms = timed(
            lambda: fc.fof_links_sweep_plain(row, links, lab))
        for mode, got in (('search', s), ('links', c), ('links_plain',
                                                        pcsr)):
            nd = int((got != p).sum())
            assert nd == 0, "%s %s %s: %d labels differ from the plain " \
                "sweep" % (label, name, mode, nd)
        at[name] = dict(
            search_ms=cuda_ms(lambda: fc.fof_sweep_cuda(*args, lab, *geo,
                                                        cols=cols), reps=5),
            links_ms=cuda_ms(lambda: fc.fof_links_sweep_cuda(row, links,
                                                             lab), reps=20),
            plain_ms=plain_ms, links_plain_ms=csr_plain_ms,
            changed=int((p != lab).sum()))
    assert at['fixpoint']['changed'] == 0 < at['first_sweep']['changed']
    # the library call beside the links sweep: one scatter_reduce of the
    # same CSR min, its index and source operands made beforehand
    owner = torch.repeat_interleave(
        torch.arange(n, device='cuda'), row[1:] - row[:-1])
    vals = lab0[links.long()]
    scatter_ms = cuda_ms(lambda: lab0.scatter_reduce(0, owner, vals, 'amin'),
                         reps=20)
    del owner, vals
    kmax = int(torch.unique_consecutive(grid.flat_s,
                                        return_counts=True)[1].max())

    def rec(ms, plain_ms, nbytes, library_ms=None, **extra):
        b_ms, b_by = bound(nbytes, 0, F32_FLOPS)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=0,
                    share_of_bound=b_ms / ms, **extra)
    where = '%s f%d n=%d, %s cells, kmax %d, E=%d' % (
        label, 8 * pb, n, 'x'.join(str(int(c)) for c in grid.ncell_np),
        kmax, E)
    out = {
        'fof_link_count': rec(count_ms, count_plain_ms,
                              fc.link_count_bytes(n, pb, kb, grid.ncell_np),
                              at=where),
        'fof_link_fill': rec(fill_ms, fill_plain_ms,
                             fc.link_fill_bytes(n, E, pb, kb, grid.ncell_np),
                             at=where),
        'links': rec(at['first_sweep']['links_ms'],
                     at['first_sweep']['plain_ms'],
                     fc.links_sweep_bytes(n, E), library_ms=scatter_ms,
                     at_fixpoint_ms=at['fixpoint']['links_ms'],
                     links_plain_ms=at['first_sweep']['links_plain_ms'],
                     at=where + ', CSR min'),
        'search': rec(at['first_sweep']['search_ms'],
                      at['first_sweep']['plain_ms'],
                      fc.sweep_bytes(n, pb, kb)
                      + fc.column_bytes(grid.ncell_np),
                      at_fixpoint_ms=at['fixpoint']['search_ms'],
                      at=where + ', column search'),
    }
    # each mode's whole fixpoint against n (29 + 8 S) bytes
    fb_ms, _ = bound(fc.fixpoint_bytes(n, sweeps, pb, kb), 0, F32_FLOPS)
    names = ('fof_search_kernel', 'fof_link_count_kernel',
             'fof_link_fill_kernel', 'fof_links_sweep_kernel')
    fixpoint = {}
    # links: fof_fixpoint as the FOF runs it, the count and fill included
    for mode, run in (('links', lambda: fof_fixpoint(grid, ll)),
                      ('search', search_mode)):
        wall = cuda_ms(run, reps=3)
        dev = kernel_device_ms(run, names, reps=3)
        kern = sum(dev.values())
        fixpoint[mode] = dict(ms=wall, kernels_ms=kern,
                              kernels_device_ms=dev, bound_ms=fb_ms,
                              share_of_bound=fb_ms / kern if kern else None)
    # the mode rule's host cost: fits() as the fixpoint calls it, the
    # cudaMemGetInfo it makes, and the allocator statistics it reads when
    # the card's free memory falls short
    need = 4 * E + dh.FIXPOINT_LABEL_BYTES * n
    free = torch.cuda.mem_get_info(pos.device)[0]

    def host_us(fn, reps=50):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e6
    mode_rule = dict(need_bytes=need, card_free_bytes=free,
                     reads_allocator_stats=need > free,
                     fits_us=host_us(lambda: dh.fits(need, pos.device)),
                     mem_get_info_us=host_us(
                         lambda: torch.cuda.mem_get_info(pos.device)),
                     memory_stats_us=host_us(
                         lambda: torch.cuda.memory_stats(pos.device)))
    # the statistics branch: one byte past the card's free memory fits
    # while torch holds an unused block
    cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    assert dh.fits(free + 1, pos.device) == (cached >= 1), (free, cached)
    summary = dict(
        n=n, ncell=[int(c) for c in grid.ncell_np], kmax=kmax, links=E,
        mode_rule=mode_rule,
        links_per_particle=E / n, sweeps=sweeps,
        first_sweep_changed=at['first_sweep']['changed'],
        column_table_entries=int(cols.numel()),
        fixpoint_bound_bytes=fc.fixpoint_bytes(n, sweeps, pb, kb),
        fixpoint=fixpoint,
        kernels={k: {kk: v[kk] for kk in ('ms', 'plain_ms', 'bound_ms',
                                          'share_of_bound')}
                 for k, v in out.items()})
    emit({'phase': 'fof_modes', 'case': label, **summary,
          'check_s': time.perf_counter() - t0})
    out['summary'] = summary
    return out


def fof_sweep_checks(cat, fof):
    """The FOF kernels on the flow's 1e7 particles and on a clustered
    2e6 (``fof_mode_checks``), the flow's mode checks against the FOF
    run (its sweeps); the grid's radix order against argsort's and the
    FOF labels of an argsort-ordered run; the rank pass on the grid's
    first LSD digits and the whole 4-pass key order against
    ``torch.argsort``. Returns ({kernel: record}, rank record)."""
    from nbodykit_tpu_torch.algorithms.fof import (_fof_labels,
                                                   size_ordered_labels)
    from nbodykit_tpu_torch.kernel_variants import clustered_catalog
    from nbodykit_tpu_torch.ops.devicehash import DeviceGridHash
    from nbodykit_tpu_torch.ops.radix import digit_plan, stable_key_order
    pos = cat['Position']
    box, ll = fof.attrs['BoxSize'], fof._ll
    flow = fof_mode_checks('fof_1024', pos, box, ll)
    assert flow['summary']['sweeps'] == fof.sweeps, \
        (flow['summary']['sweeps'], fof.sweeps)
    assert flow['summary']['links'] == fof.links
    cpos, cll = clustered_catalog()
    clustered = fof_mode_checks('clustered_2e6', cpos, np.full(3, 1000.0),
                                cll)
    del cpos
    torch.cuda.empty_cache()

    # the cell order: radix (the default on the card) against argsort
    grid = DeviceGridHash(pos, box, ll)
    n = pos.shape[0]
    order_a = DeviceGridHash(pos, box, ll, order='argsort').order
    assert torch.equal(order_a, grid.order)
    labels_a, nh = size_ordered_labels(
        _fof_labels(pos, box, ll, order='argsort'), FOF_NMIN)
    assert torch.equal(labels_a, fof.labels) and nh == fof._halo_count
    D = grid.ncells_tot + 1
    passes, base = digit_plan(D)
    keys = grid._flatten(grid.cell_of(pos)).contiguous()
    rank = time_rank(n, base, plain_reps=1, digits=keys % base)
    order_ms = cuda_ms(lambda: stable_key_order(keys, D), reps=5)
    argsort_ms = cuda_ms(lambda: torch.argsort(keys, stable=True), reps=5)
    at_clustered = {k: clustered[k] for k in ('fof_link_count',
                                              'fof_link_fill')}
    modes = {m: dict(flow[m], at_clustered_2e6=clustered[m])
             for m in ('links', 'search')}
    recs = {
        # the flow takes the links mode: its row is that mode's sweep
        'fof_sweep': dict(flow['links'], modes=modes,
                          fixpoint=flow['summary']['fixpoint'],
                          fixpoint_clustered_2e6=clustered['summary']
                          ['fixpoint']),
        'fof_link_count': dict(flow['fof_link_count'],
                               at_clustered_2e6=at_clustered
                               ['fof_link_count']),
        'fof_link_fill': dict(flow['fof_link_fill'],
                              at_clustered_2e6=at_clustered['fof_link_fill']),
    }
    emit({'phase': 'fof_kernels', 'sweeps': fof.sweeps,
          'sweep_mode': fof.sweep_mode, 'links': fof.links,
          'radix_vs_argsort_labels': 'equal',
          'key_order': {'alphabet': D, 'passes': passes, 'base': base,
                        'radix_4_pass_ms': order_ms,
                        'argsort_stable_ms': argsort_ms,
                        'rank_pass_first_digit': rank}})
    return recs, rank


def fof_stages(cat):
    """LN_REPS runs of the FOF Algorithm with ``utils.stage_timer`` set:
    the grid (keys, 4 rank passes, gathers), the sweeps to the fixpoint,
    the size-ordered relabel, fof_catalog and to_halos."""
    from nbodykit_tpu_torch import utils
    times = StageTimes()
    utils.stage_timer = times
    try:
        for _ in range(LN_REPS):
            fof_algorithm(cat)
    finally:
        utils.stage_timer = None
    summary = {k: {'median': float(np.median(v)), 'min': min(v),
                   'max': max(v), 'windows': len(v)}
               for k, v in times.ms.items()}
    emit({'phase': 'fof_stages', 'reps': LN_REPS, 'ms': summary})


def fftrecon_run(data, randoms):
    """FFTRecon (LGS, bias 2, f 0.77, R 15) at RC_NMESH and FFTPower
    (mode '1d') of the reconstructed field."""
    from nbodykit_tpu_torch.lab import FFTPower, FFTRecon, FieldMesh
    recon = FFTRecon(data, randoms, Nmesh=RC_NMESH, bias=2.0, f=0.77, R=15,
                     scheme='LGS')
    field = recon.compute()
    return recon, field, FFTPower(FieldMesh(field), mode='1d')


def fftrecon_path(data):
    """The FFTRecon flow on the FOF path's catalog with ~1e8 uniform
    randoms: once with launches counted and the peak memory; the gates
    (mean of the field at 0, finite P(k), and the mxu paints against
    the index_add_ paints, below); then one warm-up and LN_REPS timed
    calls.

    The paints are held to 1e-5 of the field's maximum at the run's own
    displacements: the displacements of an index_add_-painted data
    field within 1e-5 of their maximum, then the three paints of each
    method on the same shifts. Two whole runs differ by more: the
    shifted positions are f4 (as in the JAX package) at up to 5000
    Mpc/h, where one ulp is 4.9e-4 Mpc/h (5e-5 of a 512^3 cell), so a
    displacement that differs in its last bit moves a particle by a
    whole position ulp; the whole-run difference is printed, not
    gated."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    randoms = UniformCatalog(nbar=10 * LN_N / LN_BOX ** 3, BoxSize=LN_BOX,
                             seed=84)
    randoms['Position']
    with counted_launches() as launches:
        torch.cuda.reset_peak_memory_stats()
        recon, field, p = fftrecon_run(data, randoms)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    # three paints (data, shifted randoms, shifted data), their buckets
    # ordered by rank passes (two each at 512^3)
    assert launches['paint_deposit'] == 3, launches
    assert launches['radix_rank'] >= 3, launches
    value = field.value
    mean = float(value.double().mean())
    fmax = float(value.abs().max())
    assert abs(mean) <= 1e-4, "reconstructed field mean %r" % mean
    s_d, s_r = recon._compute_s()
    with set_options(paint_method='scatter'):
        plain = fftrecon_run(data, randoms)[1].value
        s_d2, s_r2 = recon._compute_s()
        shifted = recon._helper_paint(s_d, s_r).value
    whole_diff = float((plain - value).abs().max())
    s_max = float(torch.maximum(s_d.abs().max(), s_r.abs().max()))
    s_diff = float(torch.maximum((s_d - s_d2).abs().max(),
                                 (s_r - s_r2).abs().max()))
    del plain, s_d2, s_r2
    assert s_diff <= 1e-5 * s_max, \
        "displacements, mxu vs index_add_ data paint: %g > 1e-5 * %g" % (
            s_diff, s_max)
    mxu = recon._helper_paint(s_d, s_r).value
    diff = float((shifted - mxu).abs().max())
    del shifted, mxu, s_d, s_r
    assert diff <= 1e-5 * fmax, \
        "mxu vs index_add_ paints: %g > 1e-5 * %g" % (diff, fmax)
    P, modes = p.power['power'].real, p.power['modes']
    assert np.isfinite(P[modes > 0]).all()
    del recon, field, value, p
    torch.cuda.empty_cache()
    fftrecon_run(data, randoms)
    t = spread(lambda: fftrecon_run(data, randoms), LN_REPS)[1]
    emit({'phase': 'fftrecon_512', 'nmesh': RC_NMESH, 'N_data': len(data),
          'N_randoms': len(randoms), 'field_mean': mean, 'field_max': fmax,
          'mxu_vs_scatter_paints_max_abs': diff,
          'displacement_max_abs_diff': s_diff, 'displacement_max': s_max,
          'whole_run_vs_scatter_max_abs': whole_diff,
          'nbins_k': int(len(P)),
          'peak_gb': peak / 1e9, 'launches': launches, 'reps': LN_REPS,
          'ms': t})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    from nbodykit_tpu_torch import _build
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')

    name = torch.cuda.get_device_name(0)
    smi = smi_query('name,power.limit')
    # the CUDA kernels; class_path builds and times the Boltzmann library
    t0 = time.perf_counter()
    logs = _build.build_all(_build.sources())
    build_s = time.perf_counter() - t0
    for src, log in logs.items():
        print('nvcc %s:\n%s' % (src, log), file=sys.stderr)
    hash_ops, hash_opcodes = sass_hash_ops()
    clocks, limit = hash_clocks(hash_opcodes)
    emit({'phase': 'device', 'name': name, 'nvidia_smi': smi,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_s': build_s,
          'built': sorted(logs), 'threefry_hash_int_ops_sass': hash_ops,
          'threefry_hash_opcodes': hash_opcodes,
          'threefry_hash_clocks_per_sm': clocks,
          'threefry_hash_limit': limit})

    check_rank()
    nmesh = 512
    with counted_launches() as cat_launches:
        cat = UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42)
    assert cat_launches['threefry_fill'] >= 2, cat_launches
    rank_rec = time_rank(len(cat))
    dep_rec = check_deposit(cat, nmesh)
    run_launches, run = main_path(cat, nmesh)
    # the 512^3 path: the catalog's draws, then the counted FFTPower run
    launches = {k: cat_launches[k] + run_launches[k] for k in cat_launches}
    paint_breakdown(cat, nmesh)
    profile_main_path(run)
    other_fft_algorithms(cat, nmesh)
    del cat, run
    torch.cuda.empty_cache()

    check_rng()
    torch.cuda.empty_cache()
    check_linear_mesh()
    torch.cuda.empty_cache()
    ln_cat, ln_launches, ln_run = lognormal_path()
    lognormal_stages(ln_cat)
    pois_modes = time_poisson(lognormal_lam(LN_NMESH, LN_BOX, LN_SEED),
                              hash_opcodes, LN_N)
    torch.cuda.empty_cache()
    profile_main_path(ln_run, 'lognormal_1024')
    del ln_cat, ln_run
    torch.cuda.empty_cache()
    cl_launches = class_path()
    torch.cuda.empty_cache()
    tf_rec = time_threefry(LN_NMESH ** 3, hash_opcodes)
    torch.cuda.empty_cache()

    cp_mesh, cp_launches = convpower_path()
    convpower_stages(cp_mesh)
    profile_main_path(lambda: convpower_algorithm(cp_mesh),
                      'convpower_1024')
    cp_dep, cp_rank = convpower_kernels(cp_mesh)
    del cp_mesh
    torch.cuda.empty_cache()

    fof_cat, fof_launches, (fof_recs, fof_rank) = fof_path()
    fof_stages(fof_cat)
    profile_main_path(lambda: fof_algorithm(fof_cat), 'fof_1024')
    rc_launches = fftrecon_path(fof_cat)
    del fof_cat
    torch.cuda.empty_cache()

    paths = ('main_512', 'lognormal_1024', 'class_1024', 'convpower_1024',
             'fof_1024', 'fftrecon_512')

    def counted(name):
        by_path = dict(zip(paths, (launches[name], ln_launches[name],
                                   cl_launches[name], cp_launches[name],
                                   fof_launches[name],
                                   rc_launches[name])))
        return dict(launches=sum(by_path.values()),
                    launches_by_path=by_path)

    def poisson_counted():
        # one row, two modes: the occupied cells on the lognormal path
        modes = {'full_mesh': counted('poisson_threefry'),
                 'occupied_cells': counted('poisson_cells')}
        return dict(
            launches=sum(m['launches'] for m in modes.values()),
            launches_by_path={p: sum(m['launches_by_path'][p]
                                     for m in modes.values())
                              for p in paths},
            launches_by_mode={k: m['launches'] for k, m in modes.items()})
    def fof_sweep_counted():
        # one row, two modes: the links mode on the FOF path
        by_mode = {'links': counted('fof_sweep_links'),
                   'search': counted('fof_sweep_search')}
        return dict(counted('fof_sweep'),
                    launches_by_mode={k: m['launches']
                                      for k, m in by_mode.items()})
    fof_src = 'nbodykit_tpu_torch/csrc/fof_sweep.cu'
    fof_replaces = ('nbodykit_tpu/ops/devicehash.py:190 neighbor_min (XLA '
                    'while_loop of gathers; no Pallas kernel)')
    rng_src = 'nbodykit_tpu_torch/csrc/threefry.cu'
    rng_replaces = 'jax.random threefry2x32 / poisson (XLA; no Pallas kernel)'
    kernels = [
        dict(name='radix_rank', route='cuda',
             source='nbodykit_tpu_torch/csrc/radix_rank.cu',
             replaces='nbodykit_tpu/ops/radix_pallas.py:30',
             **counted('radix_rank'), **rank_rec,
             at_convpower_1024=cp_rank, at_fof_1024=fof_rank),
        dict(name='paint_deposit', route='cuda',
             source='nbodykit_tpu_torch/csrc/paint_deposit.cu',
             replaces='nbodykit_tpu/ops/paint_pallas.py:37',
             **counted('paint_deposit'), **dep_rec,
             at_convpower_1024=cp_dep),
        dict(name='threefry_fill', route='cuda', source=rng_src,
             replaces=rng_replaces, **counted('threefry_fill'), **tf_rec),
        dict(name='poisson_threefry', route='cuda', source=rng_src,
             replaces=rng_replaces, **poisson_counted(),
             **pois_modes['occupied_cells'], modes=pois_modes),
        dict(name='fof_sweep', route='cuda', source=fof_src,
             replaces=fof_replaces, **fof_sweep_counted(),
             **fof_recs['fof_sweep']),
        dict(name='fof_link_count', route='cuda', source=fof_src,
             replaces=fof_replaces, **counted('fof_link_count'),
             **fof_recs['fof_link_count']),
        dict(name='fof_link_fill', route='cuda', source=fof_src,
             replaces=fof_replaces, **counted('fof_link_fill'),
             **fof_recs['fof_link_fill']),
    ]
    for kern in kernels:
        kern['share_of_bound'] = kern['bound_ms'] / kern['ms']
    emit({'kernels': kernels})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
