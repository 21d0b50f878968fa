#!/usr/bin/env python3
"""Drive the PyTorch port (``nbodykit_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``nbodykit_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives
the main path (a UniformCatalog of ~1e7 particles painted onto a 512^3
CIC mesh, compensated, FFTPower in (k, mu) with multipoles) and checks
what comes out. Every check is an ``assert`` or a raise, so any failure
exits non-zero. Output: one JSON line per phase; then the ``kernels``
line, the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. Times are CUDA-event times on this card.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# calls per timed phase of the main path
REPS = 5


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


def rank_cases(gen):
    """(label, digits, D) of the rank pass's checks: random digits at n
    around one chunk and at the main path's sizes for D in {1, 2, 65,
    1024}, then all-equal, sorted and reverse-sorted digits."""
    from nbodykit_tpu_torch.ops.radix_cuda import KERNEL_CHUNK as C

    def rand(n, D):
        return torch.randint(0, D, (n,), generator=gen, device='cuda',
                             dtype=torch.int32)
    for n in (1, C - 1, C, C + 1, 10 ** 6, 10 ** 7):
        for D in (1, 2, 65, 1024):
            yield 'random n=%d D=%d' % (n, D), rand(n, D), D
    for D in (65, 1024):
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
    for D in (65, 1024):
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


def time_rank(n, D=65):
    """Rank pass times at the main path's shape (n particles, 2 LSD
    passes of 65 digits at 512^3): the kernel alone (CUDA events around
    the C call into preallocated outputs, the status words' clearing
    included, and the kernel's device time from the profiler), the
    wrapper (checks and allocation), the plain version and
    ``torch.argsort``."""
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   rank_pass_launch,
                                                   rank_plan)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(11)
    d = torch.randint(0, D, (n,), generator=gen, device='cuda',
                      dtype=torch.int32)
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
    plain_ms = cuda_ms(lambda: pass_rank_hist_plain(d, D), reps=2)
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
                 slack=2.0):
    """Kernel vs plain deposit on the mxu payload of one catalog."""
    from nbodykit_tpu_torch.ops.paint import mxu_payload, mxu_plan
    from nbodykit_tpu_torch.ops.paint_cuda import (deposit_blocks_cuda,
                                                   deposit_blocks_plain,
                                                   deposit_plan)
    plan = mxu_plan(pos_cells.shape[0], shape, resampler, period,
                    mass.element_size(), slack=slack)
    sx, sy, sz, sm, over = mxu_payload(pos_cells, mass, plan, resampler,
                                       origin, 'radix')
    assert int(over) == 0, "bucket overflow in %s" % label
    geom = dict(resampler=resampler, rb=plan['rb'], cb=plan['cb'],
                n0l=int(shape[0]), p0=int(period[0]), N1=int(shape[1]),
                N2=int(shape[2]), origin=origin)
    got = deposit_blocks_cuda(sx, sy, sz, sm, **geom)
    ref = deposit_blocks_plain(sx, sy, sz, sm, ck=plan['ck'], **geom)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = (1e-12 if sm.dtype == torch.float64 else 1e-5) * scale
    total, mass_in = float(got.double().sum()), float(sm.double().sum())
    lplan = deposit_plan(got.shape[2], got.shape[3], got.element_size())
    emit({'phase': 'deposit_check', 'case': label, 'max_abs_err': err,
          'max_abs_block': scale, 'tol': tol, 'blocks': list(got.shape),
          'cluster': lplan['nz'], 'z_cells_per_cta': lplan['zc'],
          'ragged': lplan['ragged'], 'blocks_sum': total,
          'payload_mass': mass_in})
    assert np.isfinite(err) and err <= tol, \
        "deposit %s: max |kernel - plain| %g > %g" % (label, err, tol)
    # every window sums to one: the blocks hold the payload's mass
    assert abs(total - mass_in) <= 1e-5 * mass_in, \
        "deposit %s does not conserve mass" % label
    return plan, (sx, sy, sz, sm), geom, err


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
    from nbodykit_tpu_torch.ops.paint_cuda import (deposit_blocks_cuda,
                                                   deposit_blocks_plain)
    from nbodykit_tpu_torch.ops.window import window_support
    full = (nmesh,) * 3
    pos = cat['Position'] * (nmesh / float(cat.attrs['BoxSize'][0]))
    mass = torch.ones(pos.shape[0], dtype=torch.float32, device='cuda')
    plan, payload, geom, err = deposit_case(
        'cic %d^3 n=%d' % (nmesh, pos.shape[0]), pos, mass, full, full, 0,
        'cic')
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

    sx, sy, sz, sm = payload
    ms = cuda_ms(lambda: deposit_blocks_cuda(sx, sy, sz, sm, **geom),
                 reps=10)
    plain_ms = cuda_ms(lambda: deposit_blocks_plain(sx, sy, sz, sm,
                                                    ck=plan['ck'], **geom),
                       reps=1, warmup=0)
    s = window_support('cic')
    M = (plan['rb'] + s - 1) * (plan['cb'] + s - 1)
    T, nty, K = sx.shape
    # every slot's mass is read; the positions only of occupied slots
    # (mass != 0), which are all the kernel and the function need
    occupied = int((sm != 0).sum())
    nbytes = T * nty * K * sm.element_size() \
        + occupied * 3 * sx.element_size() \
        + T * nty * M * nmesh * sm.element_size()
    # the deposit's own arithmetic: 2 flops per term for the s^3 terms
    # of each occupied slot
    flops = occupied * 2 * s ** 3
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err,
                at='cic %d^3 blocks %s payload %s, %d slots occupied' % (
                    nmesh, [T, nty, M, nmesh], [T, nty, K], occupied))


def main_path(cat, nmesh):
    """FFTPower on the catalog at full width through the user entry
    points, with both kernels' launches counted."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.algorithms.fftpower import (FFTPower,
                                                        project_to_basis)
    from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_cuda
    from nbodykit_tpu_torch.ops.radix_cuda import pass_rank_hist_cuda

    def run():
        mesh = cat.to_mesh(Nmesh=nmesh, resampler='cic', compensated=True)
        return mesh, FFTPower(mesh, mode='2d', Nmu=5, poles=[0, 2, 4])

    run()                                            # warm-up
    torch.cuda.synchronize()
    pass_rank_hist_cuda.launches = 0
    deposit_blocks_cuda.launches = 0
    t0 = time.perf_counter()
    mesh, r = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {'radix_rank': pass_rank_hist_cuda.launches,
                'paint_deposit': deposit_blocks_cuda.launches}
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


def profile_main_path(run):
    """One main-path run under ``torch.profiler``: device busy time, the
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
    emit({'phase': 'profile', 'wall_ms_profiled': wall_ms,
          'device_busy_ms': busy_ms,
          'device_idle_share': (1 - busy_ms / wall_ms) if busy_ms else None,
          'device_time_visible': bool(busy_ms),
          'top_kernels': [[e.key[:90], e.count, _device_us(e) / 1e3]
                          for e in top]})


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
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for src, log in logs.items():
        print('nvcc %s:\n%s' % (src, log), file=sys.stderr)
    emit({'phase': 'device', 'name': name, 'nvidia_smi': smi,
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_s': build_s,
          'built': sorted(logs)})

    check_rank()
    nmesh = 512
    cat = UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42)
    rank_rec = time_rank(len(cat))
    dep_rec = check_deposit(cat, nmesh)
    launches, run = main_path(cat, nmesh)
    paint_breakdown(cat, nmesh)
    profile_main_path(run)

    kernels = [
        dict(name='radix_rank', route='cuda',
             source='nbodykit_tpu_torch/csrc/radix_rank.cu',
             replaces='nbodykit_tpu/ops/radix_pallas.py:30',
             launches=launches['radix_rank'], **rank_rec),
        dict(name='paint_deposit', route='cuda',
             source='nbodykit_tpu_torch/csrc/paint_deposit.cu',
             replaces='nbodykit_tpu/ops/paint_pallas.py:37',
             launches=launches['paint_deposit'], **dep_rec),
    ]
    emit({'kernels': kernels})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
