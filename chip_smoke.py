#!/usr/bin/env python3
"""Drive the PyTorch port (``nbodykit_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the hand-written kernels from ``nbodykit_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, and
drives eleven paths through the user entry points:

- the main path: a UniformCatalog of ~1e7 threefry particles painted
  onto a 512^3 CIC mesh, compensated, FFTPower in (k, mu) with
  multipoles; then FFTCorr and ProjectedFFTPower once on its mesh; then
  the other paint families on it (``paint_families``: sort, segsum by
  radix and by argsort, streams with 4 replicas; each field against the
  scatter field, FFTPower's gates, times, peaks and stages; the rank
  pass at the segsum paint's 2^27-cell alphabet) and bf16 storage
  (``mesh_bf16``: FFTPower at ``mesh_dtype='bf16'`` against the f8 run,
  mass, the peaks of paint + r2c at 1024^3 in f4 and bf16);
- the main path across ranks (``dist_main``, after FFTCorr and
  ProjectedFFTPower): the same catalog and FFTPower at P = 2 and P = 4
  processes spawned on card 0 and joined over gloo (collectives staged
  through the host; not multi-card scaling), each held against the
  one-rank run: modes, P(k, mu) and the poles within 1e-4, the
  gathered painted field within 1e-5 of its largest value, every rank's
  exchange rank pass (D = P) bit for bit against its plain version and
  rank 0's extended-slab deposit within its tolerance; stage times,
  peaks and launches a rank; then, in the same worlds, the convpower
  flow's catalogs at Nmesh 512 (``dist_convpower``, at P = 2 only: the
  poles within
  1e-8, alpha, the normalizations and the shot noise within 1e-10 of
  the one-rank run, the flow's physical gates; every rank's exchange
  rank pass on its randoms' destinations bit for bit; rank 0's TSC f8
  slab deposits of the data and of 16 stripes of the randoms) and the
  FFTRecon flow (``dist_recon``: the field gathered to rank 0 within
  1e-4 of its largest value, P(k) within 1e-4; rank 0's CIC f4 slab
  deposit of the shifted randoms), each held against a one-rank run of
  the same configuration; ``dist_bispectrum``, ``dist_forward``,
  ``dist_fof`` and ``dist_particles`` (see ``dist_rank``),
  then
  ``dist_groups`` (the particles path's 3PCF, CGM and FiberCollisions,
  the direct Bispectrum of the imprinted 1e6 catalog at nbins 8 and
  HaloCatalog.populate of 1e6 seeded halos: zetas within 1e-12, CGM's
  columns and rounds, FiberCollisions against the one-rank partition
  relabelled by the slab rule and the galaxies bit for bit, B within
  1e-10; the rank pass on each route; replayed on rank 0's inputs from
  the run: the 3PCF moments chunk, FiberCollisions' link count, link
  fill and links sweep, populate's threefry and Poisson draws) and, at
  P = 4, ``dist_tasks`` (TaskManager(2) farming four FFTPower tasks at
  256^3, each against its one-rank run; replayed: every rank's first
  exchange rank pass, rank 0's first deposit). ``python3 chip_smoke.py
  --dist-nccl`` on a host of 4 cards runs only these phases over NCCL,
  one rank a card;
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
  host, then populate(Zheng07Model, seed=42) once; the FOF kernels on
  its grid and a clustered 2e6, the link count and fill against their
  plain versions on every query and their first and tile designs
  (``csrc/variants/``) in turns, bit for bit, and on three small grids
  of the other key widths;
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
- the io path (after the FFTRecon path): the bigfile reader built with g++; the FOF path's
  lognormal catalog saved (Position, Velocity) and reloaded with
  BigFileCatalog, bit for bit on the card, then its compensated CIC
  mesh and FFTPower against the in-memory run; the convpower path's
  99,976,127 randoms (f8 Position, 2.4 GB) written, then read cold
  (page cache dropped) and warm, with the host-to-device copy; the
  painted 1024^3 f4 field saved (4.3 GB, 32 part files) and reloaded
  with BigFileMesh, bit for bit, FFTPower equal to 1e-12; all under a
  temporary directory in $TMPDIR, removed at the end;
- the particles path (after the io path): the reference's boss_like
  sample (``benchmarks/conftest.py:24``), LogNormalCatalog(LinearPower(
  Planck15, 0.55, 'EisensteinHu'), nbar=1e6/2500^3, BoxSize=2500,
  Nmesh=1024, bias=2, seed=42) with seeded Weight and Mass columns;
  SimulationBox2PCF in '1d', '2d' and 'projected', a cross count against
  1e6 uniform randoms (seed 84), SimulationBox3PCF at poles 0-4; the
  catalog and the randoms on the sky from the box centre, SurveyData2PCF
  ('2d'), an angular SurveyDataPairCount and FiberCollisions at 62";
  KDDensity and CylindricalGroups (rperp 2, rpar 10); every pair count
  the flow launched replayed (strided queries against the plain
  version, an auto count once a pair against every pair, the kernel
  timed beside its first design from ``csrc/variants/`` and its bound),
  the 1d auto count against the plain version on all queries, the 3PCF
  moments of the first chunk whole against theirs and timed beside
  their first design; FiberCollisions' link count and fill and
  KDDensity's count replayed on every query against their plain
  versions and their first and tile designs;
- the bispectrum path (after the particles path): Bispectrum(
  UniformCatalog(nbar=1e-2, BoxSize=1000, seed=42), nbins=16,
  Nmesh=256, method='fft') (564 triangles, alias-free), the deposit and
  the rank pass against their plain versions on its f8 paint; the FFT
  and direct estimators on bench.py's imprinted-weight catalog (1e6 in
  1000, nbins 8): ntri identical, B within 2e-2 of the largest; the
  pairblock sum and the triple sum beside their bounds; the numpy
  oracles of tests/test_bispectrum.py on small cases;
- the forward path (last): ForwardModel(128, 128^3, BoxSize=1000,
  pm_steps=2, delta_rms=0.36, dtype='f8') (the grad-mode paint demoted
  from mxu to scatter), the density's and one value-and-gradient's
  times, one value and gradient with each custom-VJP paint (sort,
  segsum, streams) against scatter's, 40 Adam steps (lr 0.01) from the
  linear start beating FFTRecon on mean_cross_correlation, and the
  loss's directional derivative against central differences (eps 1e-6)
  at 32^3;

and LinearMesh at the same scale against its exact expectation. Every
check is an ``assert`` or a raise, so any failure exits non-zero.
Output: one JSON line per phase; then the ``kernels`` line, the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Without CUDA it exits 1 and prints no result. Times are
CUDA-event times on this card.
"""

import concurrent.futures
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
# the same FP64 lanes for separate operations (one a lane a clock; the
# data sheet's rate counts a fused multiply-add as two): the rate of the
# pair kernels, built with -fmad=false, whose operation counts count
# each add, multiply and compare as one
F64_UNFUSED_OPS = F64_FLOPS / 2
# F64 on the tensor cores (the same data sheet, a fused multiply-add
# counted as two): the 3PCF drain's matrix product
F64_TC_FLOPS = 67e12
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


# the script's start, for each phase line's ``script_s``
T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line also says when it was printed
    (``script_s``, seconds since the script started)."""
    if 'phase' in obj:
        obj = dict(obj, script_s=time.perf_counter() - T_START)
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


def bound(nbytes, flops, peak_flops, more=()):
    """(ms, 'bytes' or 'operations'): the least time of the work; ``more``
    (operations, peak) of the work's other units, their times added."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak_flops + sum(o / p for o, p in more)) * 1e3
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
    err, lplan = payload_deposit_check(label, (sx, sy, sz, sm), geom,
                                       plan['ck'], stripes, check_order)
    return plan, (sx, sy, sz, sm), geom, err, lplan


def payload_deposit_check(label, payload, geom, ck, stripes=None,
                          radix_equals_argsort=False):
    """The deposit kernel against its plain version on one mxu payload
    (sx, sy, sz, sm), or on its first ``stripes`` x-stripes: within
    1e-12 (f8 mesh) or 1e-5 (f4) of the largest block value, the blocks
    holding the payload's mass. Returns (max |kernel - plain|, deposit
    launch plan)."""
    from nbodykit_tpu_torch.ops.paint_cuda import (deposit_blocks_cuda,
                                                   deposit_blocks_plain,
                                                   deposit_plan)
    sub = payload if stripes is None else \
        tuple(a[:stripes].contiguous() for a in payload)
    got = deposit_blocks_cuda(*sub, **geom)
    ref = deposit_blocks_plain(*sub, ck=ck, **geom)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = (1e-12 if sub[3].dtype == torch.float64 else 1e-5) * scale
    total, mass_in = float(got.double().sum()), float(sub[3].double().sum())
    lplan = deposit_plan(got.shape[2], got.shape[3], got.element_size())
    blocks = list(got.shape)
    del got, ref, sub
    emit({'phase': 'deposit_check', 'case': label, 'max_abs_err': err,
          'max_abs_block': scale, 'tol': tol, 'blocks': blocks,
          'cluster': lplan['nz'], 'z_cells_per_cta': lplan['zc'],
          'ragged': lplan['ragged'], 'blocks_sum': total,
          'payload_mass': mass_in,
          'radix_equals_argsort': radix_equals_argsort,
          'stripes_checked': stripes or blocks[0]})
    assert np.isfinite(err) and err <= tol, \
        "deposit %s: max |kernel - plain| %g > %g" % (label, err, tol)
    # every window sums to one: the blocks hold the payload's mass
    assert abs(total - mass_in) <= 1e-5 * mass_in, \
        "deposit %s does not conserve mass" % label
    return err, lplan


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
    from nbodykit_tpu_torch.ops.paircount_cuda import paircount_hist_cuda
    from nbodykit_tpu_torch.ops.radix_cuda import pass_rank_hist_cuda
    from nbodykit_tpu_torch.ops.threept_cuda import threept_alm_cuda
    return {'radix_rank': pass_rank_hist_cuda,
            'paint_deposit': deposit_blocks_cuda,
            'threefry_fill': tf.threefry_fill_cuda,
            'poisson_threefry': tf.poisson_threefry_cuda,
            'poisson_cells': tf.poisson_cells_cuda,
            'fof_sweep_search': fc.fof_sweep_cuda,
            'fof_sweep_links': fc.fof_links_sweep_cuda,
            'fof_link_count': fc.fof_link_count_cuda,
            'fof_link_fill': fc.fof_link_fill_cuda,
            'paircount_hist': paircount_hist_cuda,
            'threept_alm': threept_alm_cuda}


# the FOF's kernels: launched by FOF, FiberCollisions and KDDensity only
FOF_KERNELS = ('fof_sweep', 'fof_sweep_search', 'fof_sweep_links',
               'fof_link_count', 'fof_link_fill')
# the particle statistics' kernels: no path but the particles path
PARTICLE_KERNELS = ('paircount_hist', 'threept_alm')


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


def main_run(cat, nmesh):
    """The main path as a closure: the catalog's compensated CIC mesh
    and its FFTPower in (k, mu) with poles 0, 2, 4."""
    from nbodykit_tpu_torch.algorithms.fftpower import FFTPower

    def run():
        mesh = cat.to_mesh(Nmesh=nmesh, resampler='cic', compensated=True)
        return mesh, FFTPower(mesh, mode='2d', Nmu=5, poles=[0, 2, 4])
    return run


def main_path(cat, nmesh):
    """FFTPower on the catalog at full width through the user entry
    points, with every kernel's launches counted."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.algorithms.fftpower import project_to_basis

    run = main_run(cat, nmesh)
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
    assert P.shape == (len(edges[0]) - 1, 5), P.shape
    ratio = pole_ratios(r, nmesh, cat)
    emit({'phase': 'main_path', 'nmesh': nmesh, 'npart': len(cat),
          'launches': launches, 'wall_s': wall_s, 'reps': REPS,
          'phases_ms': phases, 'field_mean': mean,
          'mxu_vs_scatter_max_abs': diff, 'shotnoise': shot,
          'P_over_shot_mean_k_lt_half_nyq': ratio,
          'nbins_k': int(P.shape[0])})
    return launches, run


def pole_ratios(r, nmesh, cat):
    """The main path's gates on an FFTPower of the uniform catalog
    (mode '2d', poles 0, 2, 4): finite power, and the mode-weighted
    P0 / shot noise within 0.02 of 1 below k_Nyquist / 2, P2 and P4
    within 0.02 of 0. Returns the three ratios."""
    shot = r.attrs['shotnoise']
    P, modes = r.power['power'].real, r.power['modes']
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
    return ratio


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


# the paint families of the main path's mesh, each a set of options
PAINT_FAMILIES = (
    ('sort', dict(paint_method='sort')),
    ('segsum_radix', dict(paint_method='segsum', paint_order='radix')),
    ('segsum_argsort', dict(paint_method='segsum', paint_order='argsort')),
    ('streams_4', dict(paint_method='streams', paint_streams=4)),
)
# a family's field against the scatter field, as the mxu paint's in
# main_path: 1e-5 of the field's largest cell (f32 sums in other orders)
FAMILY_RTOL = 1e-5
# the timed stages of the families (ops/paint.py ``utils.stage`` names)
FAMILY_STAGES = ('paint_order', 'paint_streams', 'paint_runs',
                 'paint_scatter', 'paint_deposit', 'paint_merge')


def stage_bounds(n, M, s3, runs, k, pos_bytes):
    """The bytes each family stage must move at least (each input read
    once, each output written once), f32 weights and mesh, int64 keys:
    the order (positions in, the permutation out), the sorted streams
    (positions, mass and order in; keys, s^3 weight streams and two run
    masks out), the run sums (streams and keys in, s^3 totals a run
    out), the scatter (totals and run keys in, the mesh out), the
    streams deposit (positions and mass in, k replicas out) and merge
    (k replicas in, the mesh out)."""
    return {'paint_order': 3 * n * pos_bytes + 8 * n,
            'paint_streams': 3 * n * pos_bytes + 4 * n + 8 * n + 8 * n
            + 4 * s3 * n + 2 * n,
            'paint_runs': 4 * s3 * n + 8 * n + 4 * s3 * runs,
            'paint_scatter': 4 * s3 * runs + 8 * runs + 4 * M,
            'paint_deposit': 3 * n * pos_bytes + 4 * n + 4 * k * M,
            'paint_merge': 4 * k * M + 4 * M}


def base_keys(cat, nmesh):
    """The CIC base-cell keys of the catalog on the nmesh^3 mesh (int64,
    in [0, nmesh^3)), as ``ops.paint._one_sort_streams`` forms them."""
    from nbodykit_tpu_torch.ops.paint import _axis_terms
    pos = cat['Position'] * (nmesh / float(cat.attrs['BoxSize'][0]))
    idx = [_axis_terms(pos[:, d], 'cic', nmesh)[0][:, 0] for d in range(3)]
    return (idx[0] * nmesh + idx[1]) * nmesh + idx[2]


def paint_families(cat, nmesh):
    """The sort, segsum (radix and argsort) and streams (k = 4) paints
    through the main path's entry points (``set_options`` around
    ``to_real_field`` and FFTPower): each field against the scatter
    field, FFTPower's gates, REPS paints timed, the peak of a paint,
    its stages (``utils.stage_timer``) beside their byte bounds, and the
    launches of one paint and one FFTPower each (segsum with radix must
    launch the rank pass >= 3 times: 3 passes of base 512 over the
    2^27 cells)."""
    from nbodykit_tpu_torch import set_options, utils
    from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
    from nbodykit_tpu_torch.ops.radix import digit_plan
    mesh = cat.to_mesh(Nmesh=nmesh, resampler='cic', compensated=True)
    with set_options(paint_method='scatter'):
        ref = mesh.to_real_field().value
    fmax = float(ref.abs().max())
    keys = base_keys(cat, nmesh)
    _, counts = torch.unique(keys, return_counts=True)
    runs, longest = int(counts.numel()), int(counts.max())
    del counts
    n, M = len(cat), nmesh ** 3
    pos_bytes = cat['Position'].element_size()
    bytes_by_stage = stage_bounds(n, M, 8, runs, 4, pos_bytes)
    out, all_launches = {}, {}
    for label, opts in PAINT_FAMILIES:
        with set_options(**opts):
            with counted_launches() as launches:
                field = mesh.to_real_field().value
                r = FFTPower(mesh, mode='2d', Nmu=5, poles=[0, 2, 4])
            for k, v in launches.items():
                all_launches[k] = all_launches.get(k, 0) + v
            diff = float((field - ref).abs().max())
            assert diff <= FAMILY_RTOL * fmax, \
                "%s paint vs index_add_ paint: %g > %g * %g" % (
                    label, diff, FAMILY_RTOL, fmax)
            assert launches['paint_deposit'] == 0, (label, launches)
            if label == 'segsum_radix':
                # a paint and FFTPower's paint, each digit_plan's passes
                assert launches['radix_rank'] >= \
                    2 * digit_plan(nmesh ** 3)[0], launches
            else:
                assert launches['radix_rank'] == 0, (label, launches)
            del field
            ratio = pole_ratios(r, nmesh, cat)
            del r
            _, t = spread(lambda: mesh.to_real_field(), REPS)
            torch.cuda.synchronize()
            base_gb = torch.cuda.memory_allocated() / 1e9
            _, _, peak = peak_of(lambda: mesh.to_real_field())
            times = StageTimes()
            utils.stage_timer = times
            try:
                for _ in range(REPS):
                    mesh.to_real_field()
            finally:
                utils.stage_timer = None
        stages = {}
        for name in FAMILY_STAGES:
            if name not in times.ms:
                continue
            ms = float(np.median(times.ms[name]))
            b_ms, _ = bound(bytes_by_stage[name], 0, F32_FLOPS)
            stages[name] = {'ms': ms, 'min': min(times.ms[name]),
                            'max': max(times.ms[name]),
                            'bound_ms': b_ms,
                            'bytes': bytes_by_stage[name],
                            'share': b_ms / ms}
        out[label] = dict(paint_ms=t, vs_scatter_max_abs=diff,
                          P_over_shot_mean_k_lt_half_nyq=ratio,
                          peak_gb=peak, resident_gb=base_gb,
                          launches=launches, stages=stages)
        emit({'phase': 'paint_family', 'family': label, 'nmesh': nmesh,
              'npart': n, **out[label]})
    emit({'phase': 'paint_families', 'nmesh': nmesh, 'npart': n,
          'base_cells_occupied': runs, 'longest_run': longest,
          'sort_doubling_passes': max(1, int(np.ceil(np.log2(longest)))),
          'rtol_vs_scatter': FAMILY_RTOL, 'scatter_fmax': fmax,
          'paint_ms_median': {k: v['paint_ms']['median']
                              for k, v in out.items()},
          'mxu_paint_for_comparison': 'main_path.phases_ms.paint_mxu'})
    return all_launches, keys


def segsum_rank_row(keys, nmesh):
    """The rank pass at the segsum paint's shape: the first LSD digit
    (base 512) of the base-cell keys, n ~ 1e7. The kernel against its
    plain version (exact), the kernel's time a pass, the byte bound,
    the plain version's and ``torch.argsort``'s times; then the whole
    ``order_keys`` with radix (3 passes) and with argsort over the 2^27
    cells, their orders equal."""
    from nbodykit_tpu_torch.ops.radix import digit_plan, order_keys
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   rank_pass_launch,
                                                   rank_plan,
                                                   raise_on_bad_digits)
    D_all = nmesh ** 3
    npasses, D = digit_plan(D_all)
    n = keys.shape[0]
    d = torch.remainder(keys, D).to(torch.int32).contiguous()
    rank, hist = pass_rank_hist_cuda(d, D)
    raise_on_bad_digits(d.device)
    (prank, phist), plain_ms = timed(lambda: pass_rank_hist_plain(d, D))
    assert torch.equal(rank, prank) and torch.equal(hist, phist)
    del prank, phist
    rk = torch.empty_like(d)
    hs = torch.empty(D, dtype=torch.int32, device='cuda')
    scratch = torch.empty(rank_plan(n, D)['scratch_words'],
                          dtype=torch.int64, device='cuda')
    ms = cuda_ms(lambda: rank_pass_launch(d, D, rk, hs, scratch), reps=20)
    lib_ms = cuda_ms(lambda: torch.argsort(d, stable=True), reps=10)
    b_ms, b_by = bound(n * 4 + n * 4 + D * 4, 0, F32_FLOPS)
    o_radix, radix_ms = spread(lambda: order_keys(keys, D_all, 'radix'),
                               REPS)
    o_arg, argsort_ms = spread(lambda: order_keys(keys, D_all, 'argsort'),
                               REPS)
    assert torch.equal(o_radix, o_arg)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / ms, max_abs_err=0,
               at='segsum paint: n=%d D=%d (pass 1 of %d over %d cells)'
               % (n, D, npasses, D_all))
    emit({'phase': 'segsum_rank', **row,
          'order_keys_radix_ms': radix_ms,
          'order_keys_argsort_ms': argsort_ms})
    return row


# the bf16 posture: tests/test_precision.py's incommensurate 1d edges
# in units of the fundamental, its budget to k_Nyquist / 2, and the
# mesh of the peak comparison
BF16_KMIN, BF16_DK, BF16_BUDGET = 0.31, 2.6718, 2e-2
BF16_MASS_RTOL = 5e-3
BF16_PEAK_NMESH = 1024


def paint_r2c_peak(pos, nmesh, box, dtype):
    """(paint GB, paint + r2c GB, real field GB, complex field GB, ms):
    the peak allocated above what was resident, over one paint (the
    default method) and its r2c on an nmesh^3 mesh of ``dtype``."""
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    pm = ParticleMesh(nmesh, box, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    field, paint_ms = timed(lambda: pm.paint(pos))
    paint_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    cplx = pm.r2c(field)
    torch.cuda.synchronize()
    both_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    out = (paint_gb, both_gb, field.numel() * field.element_size() / 1e9,
           cplx.numel() * cplx.element_size() / 1e9, paint_ms,
           str(field.dtype))
    del field, cplx
    torch.cuda.empty_cache()
    return out


def mesh_bf16(cat, nmesh):
    """bf16 mesh storage on the main path's catalog: FFTPower (1d,
    tests/test_precision.py's edges) with ``mesh_dtype='bf16'`` against
    the default (f8) run, identical modes and the scale-relative error
    under 2e-2 to k_Nyquist / 2; mass conservation of the bf16 paint
    (mxu, the default, and streams with bf16 replicas); the peaks of a
    paint and its r2c at 1024^3, f4 against bf16."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    box = float(cat.attrs['BoxSize'][0])
    kf = 2 * np.pi / box
    knyq = np.pi * nmesh / box

    def power(dtype):
        with set_options(mesh_dtype=dtype):
            r = FFTPower(cat, mode='1d', Nmesh=nmesh, kmin=BF16_KMIN * kf,
                         dk=BF16_DK * kf)
        return (np.asarray(r.power['k'], 'f8'),
                np.asarray(r.power['power'].real, 'f8'),
                np.asarray(r.power['modes'], 'f8'))

    with counted_launches() as launches:
        (k0, p0, m0), full_ms = timed(lambda: power('f4'))
        (k, p, m), bf16_ms = timed(lambda: power('bf16'))
    assert launches['paint_deposit'] >= 2, launches
    assert np.array_equal(m, m0), "bf16 flipped a mode's bin"
    sel = (m0 > 0) & np.isfinite(p0) & (k0 <= 0.5 * knyq)
    scale = np.abs(p0[sel]).mean()
    err = float((np.abs(p[sel] - p0[sel]) / scale).max())
    assert err < BF16_BUDGET, "bf16 P(k) err %.3e" % err

    pm = ParticleMesh(nmesh, box, dtype='bf16')
    pos = cat['Position']
    mass = {}
    for method in ('mxu', 'streams'):
        with set_options(paint_method=method):
            field = pm.paint(pos)
        assert field.dtype is torch.bfloat16
        total = float(field.double().sum())
        mass[method] = total / len(cat) - 1
        assert abs(mass[method]) < BF16_MASS_RTOL, (method, total)
        del field
    peaks = {}
    for dtype in ('f4', 'bf16'):
        paint_gb, both_gb, real_gb, cplx_gb, ms, got = paint_r2c_peak(
            pos, BF16_PEAK_NMESH, box, dtype)
        peaks[dtype] = dict(paint_peak_gb=paint_gb,
                            paint_r2c_peak_gb=both_gb, real_field_gb=real_gb,
                            complex_field_gb=cplx_gb, paint_ms=ms,
                            field_dtype=got)
    emit({'phase': 'mesh_bf16', 'nmesh': nmesh, 'npart': len(cat),
          'modes_identical': True, 'pk_max_rel_err_k_lt_half_nyq': err,
          'budget': BF16_BUDGET, 'bins': int(sel.sum()),
          'fftpower_f8_ms': full_ms, 'fftpower_bf16_ms': bf16_ms,
          'mass_rel_err': mass, 'mass_rtol': BF16_MASS_RTOL,
          'peaks_%d' % BF16_PEAK_NMESH: peaks, 'launches': launches})
    return launches


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        val = getattr(evt, attr, None)
        if val is not None:
            return val
    return 0


def profile_main_path(run, path='main_512', host_ops=True):
    """One run of a path under ``torch.profiler``: device busy time, the
    idle share of the run's wall time and the kernels that take most.
    ``host_ops=False`` records the device's activity only (no host op
    events to gather and sort after the run)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
          'device_time_visible': bool(busy_ms), 'host_ops': host_ops,
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
        assert v >= 1 or k == 'poisson_threefry' or k in FOF_KERNELS \
            or k in PARTICLE_KERNELS, \
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


def convpower_data(nmesh=CP_NMESH, comm=None):
    """The benchmark's Data phase: the data and randoms UniformCatalogs
    (this rank's rows with a ``comm``), their NZ columns from numpy, the
    FKPCatalog and its TSC mesh in f8 (the bounding box from the
    randoms). Each step is a stage of ``utils.stage_timer``."""
    from nbodykit_tpu_torch.algorithms.convpower import FKPCatalog
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    from nbodykit_tpu_torch.utils import stage
    nbar = CP_N / CP_BOX ** 3
    with stage('draws'):
        data = UniformCatalog(nbar=nbar, BoxSize=CP_BOX, seed=42,
                              comm=comm)
        randoms = UniformCatalog(nbar=10 * nbar, BoxSize=CP_BOX, seed=84,
                                 comm=comm)
    with stage('nz_columns'):
        data['NZ'] = nbar * np.ones(data.size)
        randoms['NZ'] = nbar * np.ones(randoms.size)
    with stage('fkp_catalog_and_bbox'):
        return FKPCatalog(data, randoms).to_mesh(Nmesh=nmesh,
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

    gates = convpower_gates(r, mesh, CP_NMESH)
    del r

    # the results are dropped as they come: a second catalog pair would
    # take 8 GB beside the Algorithm's peak
    convpower_data()
    t_data = spread(convpower_data, LN_REPS)[1]
    convpower_algorithm(mesh)
    t_alg = spread(lambda: convpower_algorithm(mesh), LN_REPS)[1]
    emit({'phase': 'convpower_1024', 'nmesh': CP_NMESH,
          'box': mesh.attrs['BoxSize'].tolist(),
          'box_center': mesh.attrs['BoxCenter'].tolist(), **gates,
          'peak_gb_data': peak_data / 1e9,
          'peak_gb_algorithm': peak_alg / 1e9,
          'peak_gb_reserved': reserved / 1e9,
          'launches': launches, 'reps': LN_REPS,
          'data_ms': t_data, 'algorithm_ms': t_alg})
    return mesh, launches


def convpower_gates(r, mesh, nmesh):
    """The flow's gates on a ConvolvedFFTPower result ``r`` of ``mesh``:
    alpha at N_data / N_randoms, the two normalizations within 1%, the
    number of k bins, finite poles, and (data and randoms are
    independent Poisson samples, so the field is noise) P0 at the shot
    noise and P2, P4 at 0 within 2% over 0.02 < k < 0.1, where the exact
    TSC shot-noise compensation leaves the noise flat. Returns the
    gated values."""
    fkp = mesh.source
    Nd, Nr = fkp['data'].csize, fkp['randoms'].csize
    alpha = r.attrs['alpha']
    assert abs(alpha / (Nd / Nr) - 1) <= 1e-3, (alpha, Nd, Nr)
    norms = r.attrs['data.norm'], r.attrs['randoms.norm']
    assert abs(norms[0] / norms[1] - 1) <= 0.01, norms
    poles = r.poles
    k, modes = poles['k'], poles['modes']
    nbins = len(poles['k'])
    assert nbins == len(np.arange(0, np.pi * nmesh /
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
    return {'N_data': Nd, 'N_randoms': Nr, 'alpha': alpha,
            'alpha_over_ratio_minus_1': alpha / (Nd / Nr) - 1,
            'norms': norms, 'shotnoise': shot, 'nbins_k': nbins,
            'bins_in_ratio': int(sel.sum()), 'modes_in_ratio': int(wts.sum()),
            'P_over_shot_mean_0.02_0.1': ratio}


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

# dist_main: the main path's FFTPower across P ranks, spawned processes
# that share card 0 over gloo (its collectives staged through the host);
# the rank counts, the stages each rank times and the repetitions
DIST_RANKS = (2, 4)
DIST_STAGES = ('dist_exchange', 'dist_paint_local', 'dist_halo',
               'dist_r2c', 'dist_binning_reduce')
DIST_REPS = 3
DIST_KERNELS = ('radix_rank', 'paint_deposit', 'threefry', 'fof_sweep',
                'paircount', 'threept_alm')
# the f4 bar of BASELINE.md for P(k) (relative to each column's largest)
DIST_PK_RTOL = 1e-4
# dist_convpower: the convpower flow's catalogs across ranks at
# DCP_NMESH (cut from CP_NMESH, PERF.md section 4), f8: the poles within
# DCP_PK_RTOL of each column's largest value, alpha, the normalizations
# and the shot noise within DCP_SCALAR_RTOL of the one-rank run's
DCP_NMESH = 512
# the rank counts dist_convpower runs at (P = 4 cut for the script's
# time, PERF.md section 4)
DCP_RANKS = (2,)
DCP_PK_RTOL = 1e-8
DCP_SCALARS = ('alpha', 'data.norm', 'randoms.norm', 'shotnoise')
DCP_SCALAR_RTOL = 1e-10
# dist_recon: the FFTRecon flow across ranks; the f4 field gathered to
# rank 0 within DRC_FIELD_RTOL of its largest value (the bar of
# tests/test_torch_fftrecon.py), P(k) within DIST_PK_RTOL
DRC_FIELD_RTOL = 1e-4
# x-stripes of a randoms payload that the plain deposit checks
DIST_STRIPES = 16
# dist_bispectrum: the bispectrum path's flow (BS_*) across ranks: ntri
# and its NaN pattern identical to the one-rank run's, B within
# DBS_B_RTOL relative on the closed triangles
DBS_B_RTOL = 1e-10
# dist_forward: the forward path's model (FW_*) across ranks against the
# one-rank run: the density within DFW_DENSITY_RTOL of its largest value,
# the loss within DFW_LOSS_RTOL relative, the gathered gradient within
# DFW_GRAD_RTOL of its largest (the scatter paint's atomics order its
# sums), DFW_ADAM_STEPS of recover's losses within DFW_ADAM_RTOL; the
# central differences of forward_fd_check at P = 2 within FD_RTOL
DFW_DENSITY_RTOL = 1e-9
DFW_LOSS_RTOL = 1e-9
DFW_GRAD_RTOL = 1e-6
DFW_ADAM_STEPS = 2
DFW_ADAM_RTOL = 1e-8
# dist_fof: the FOF flow (FOF_LL, FOF_NMIN, to_halos) on the lognormal
# catalog whose positions and velocities the parent saves, across ranks
# against the one-rank run: every particle's group before the nmin cut
# (named by its least member) identical, so every group the merge rounds
# stitch is held, not the halos' alone; the halo count, the halos' Mass
# (Length times the particle mass) and the partition identical; each halo's
# centre of mass within DFOF_CM_TOL
# (minimum image) and CMVelocity within DFOF_VEL_RTOL of the column's
# largest: fof_catalog_gate's bars (their f32 sums add in another order)
DFOF_CM_TOL = 1e-5 * LN_BOX
DFOF_VEL_RTOL = 1e-5
# dist_particles: the boss_like catalog and its randoms (saved by the
# parent) through the counts of DPC_COUNTS, KDDensity and a sort on a
# float column, across ranks against the one-rank run: npairs identical,
# wnpairs and the weight totals within DPC_RTOL relative, the densities
# identical, the sorted catalog bit for bit
DPC_COUNTS = ('box_1d', 'box_cross_1d', 'survey_DD')
DPC_RTOL = 1e-12
# dist_groups: the particles path's 3PCF, CGM and FiberCollisions on
# the boss_like catalogs the parent saves (Mass the CGM's rankby), the
# direct Bispectrum of the bispectrum agreement's imprinted catalog at
# BS_CHECK_NBINS, and HaloCatalog.populate (Zheng07, DGR_HOD_SEED) of
# DGR_NHALO halos seeded in the boss_like box, across ranks against the
# one-rank runs: each corr_ell within DGR_ZETA_RTOL of its largest value;
# CGM's columns and rounds identical; FiberCollisions' columns identical
# to the one-rank partition relabelled by the slab branch's rule
# (equal-size groups by least member) with the assignment run on it; the
# direct B within DBS_B_RTOL of its largest, ntri identical, the modes
# within DGR_MODES_RTOL of sum |w|; the galaxies bit for bit
DGR_ZETA_RTOL = 1e-12
DGR_MODES_RTOL = 1e-12
DGR_NHALO = 10 ** 6
DGR_HALO_SEED = 43
DGR_HOD_SEED = 42
DGR_REDSHIFT = 0.5
# dist_tasks: TaskManager(DTK_CPUS) over the world at DTK_RANKS, FFTPower
# tasks on seeded UniformCatalogs at DTK_NMESH, each held to its
# one-rank run (modes identical, P(k) within DIST_PK_RTOL)
DTK_RANKS = (4,)
DTK_CPUS = 2
DTK_SEEDS = (101, 102, 103, 104)
DTK_NMESH = 256
DTK_NBAR, DTK_BOX = 1e-3, 1000.0


def _quiet(fn, *args, **kw):
    """(fn's result, the JSON lines it printed): a rank's checks print
    nothing themselves; the parent prints their lines."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


def dist_rank(rank, nproc, workdir, ref_path, nmesh, backend, rc_pos_path,
              rc_ref_path, fw_dir, pt_dir, q):
    """One rank of ``dist_main``: joins the world of ``nproc`` ranks
    (``backend`` 'gloo': all on cuda:0, collectives staged through the
    host; 'nccl': rank r on cuda:r), draws its rows of the main path's
    UniformCatalog, runs FFTPower through the user entry points
    (DIST_REPS timed runs after a warm-up, each stage a CUDA-event
    window), checks the exchange's rank
    pass on its destinations and (rank 0) the deposit on its extended
    slab against their plain versions, gathers the painted field to
    rank 0, which compares it with the one-rank field saved at
    ``ref_path``; then runs ``dist_convpower``, ``dist_recon`` (the
    recon's data at ``rc_pos_path``, the one-rank field at
    ``rc_ref_path``), ``dist_bispectrum``, ``dist_forward`` (the
    one-rank arrays in ``fw_dir``), ``dist_fof``, ``dist_particles`` and
    ``dist_groups`` (their inputs and one-rank arrays in ``pt_dir``) and,
    at DTK_RANKS, ``dist_tasks``, and puts its record on ``q``.
    ``workdir`` holds the world's rendezvous file."""
    from nbodykit_tpu_torch import _build, utils
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   raise_on_bad_digits)
    from nbodykit_tpu_torch.ops.window import window_support
    from nbodykit_tpu_torch.parallel.exchange import exchange_by_dest
    from nbodykit_tpu_torch.parallel.runtime import (init_distributed,
                                                     world_mesh)
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    from nbodykit_tpu_torch.utils import GatherArray
    t_start = time.perf_counter()
    # every rank is on this host: gloo's sockets on the loopback device
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    # the parent built every kernel: a rank compiles nothing
    assert _build.build_all(list(DIST_KERNELS)) == {}
    device = torch.device('cuda', rank if backend == 'nccl' else 0)
    init_distributed(init_method='file://' + os.path.join(workdir, 'init'),
                     num_processes=nproc, process_id=rank, backend=backend,
                     device=device)
    torch.cuda.set_device(device)
    mesh = world_mesh()
    assert mesh.size == nproc and mesh.device == device and \
        mesh.staged == (backend == 'gloo'), mesh
    with counted_launches() as cat_launches:
        cat = UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42, comm=mesh)
    run = main_run(cat, nmesh)
    run()                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    with counted_launches() as launches:
        t0 = time.perf_counter()
        m, r = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # the exchange's rank pass, then the paint bucketing's two at 512^3
    assert launches['radix_rank'] >= 3 and launches['paint_deposit'] >= 1, \
        launches
    times = StageTimes()
    utils.stage_timer = times
    try:
        for _ in range(DIST_REPS):
            run()
    finally:
        utils.stage_timer = None
    stages = {k: {'median': float(np.median(v)), 'min': min(v),
                  'max': max(v), 'calls': len(v)}
              for k, v in times.ms.items()}
    assert set(DIST_STAGES) <= set(stages), stages
    _, whole = spread(run, DIST_REPS)

    # the exchange's rank pass at D = P on this rank's destinations
    pm = m.pm
    cpos = pm._to_cell_units(cat['Position'])
    dest = pm._route_dest(cpos).contiguous()
    got = pass_rank_hist_cuda(dest, nproc)
    raise_on_bad_digits(pm.device)
    want = pass_rank_hist_plain(dest, nproc)
    rank_same = all(torch.equal(a, b) for a, b in zip(got, want))
    assert rank_same, "rank %d: the exchange's rank pass differs" % rank
    rec = dict(rank=rank, n_rows=len(cat), csize=cat.csize, wall_s=wall_s,
               run_ms=whole, stages_ms=stages, peak_bytes=peak,
               launches=launches, cat_launches=cat_launches,
               rank_pass_bit_identical=rank_same, lines=[])
    if rank == 0:
        rec['rank_timing'], lines = _quiet(time_rank, dest.shape[0],
                                           D=nproc, digits=dest)
        rec['lines'] += lines
        # the deposit on the extended slab this rank paints
        h = window_support('cic')
        n0 = nmesh // nproc
        mass = torch.ones(len(cat), dtype=torch.float32, device='cuda')
        (cpos_r, mass_r), valid, _ = exchange_by_dest(dest, [cpos, mass],
                                                      mesh)
        mass_r = torch.where(valid, mass_r, 0.0)
        (plan, payload, geom, err, _), lines = _quiet(
            deposit_case, 'cic slab n0l=%d origin=%d of %d^3, rank 0 of %d'
            % (n0 + 2 * h, -h, nmesh, nproc), cpos_r, mass_r,
            (n0 + 2 * h, nmesh, nmesh), (nmesh,) * 3, -h, 'cic')
        rec['lines'] += lines
        rec['deposit_timing'] = time_deposit(payload, geom, plan, err)
        del cpos_r, mass_r, payload
    else:
        # the exchange is a collective: every rank takes part
        exchange_by_dest(dest, [cpos, torch.ones(len(cat), device='cuda')],
                         mesh)
    # the painted field, gathered to rank 0 and held against one rank's
    field = m.to_real_field()
    mean = float(mesh.all_reduce(field.value.double().sum())) / pm.Ntot
    whole_field = GatherArray(field.value, mesh, root=0)
    if rank == 0:
        ref = np.load(ref_path, mmap_mode='r')
        assert whole_field.shape == ref.shape, whole_field.shape
        rec['field_max_abs_diff'] = float(np.abs(whole_field - ref).max())
        rec['field_max'] = float(np.abs(ref).max())
    rec['field_mean'] = mean
    rec['power'] = {c: np.asarray(r.power[c]) for c in r.power.variables}
    rec['poles'] = {c: np.asarray(r.poles[c]) for c in r.poles.variables}
    del m, r, field, whole_field, cat, cpos, dest
    torch.cuda.empty_cache()
    rec['main_seconds'] = time.perf_counter() - t_start
    if nproc in DCP_RANKS:
        t1 = time.perf_counter()
        rec['convpower'] = dist_convpower_rank(mesh)
        rec['convpower']['seconds'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['recon'] = dist_recon_rank(mesh, rc_pos_path, rc_ref_path)
    rec['recon']['seconds'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['bispectrum'] = dist_bispectrum_rank(mesh)
    rec['bispectrum']['seconds'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['forward'] = dist_forward_rank(mesh, fw_dir)
    rec['forward']['seconds'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['fof'] = dist_fof_rank(mesh, rc_pos_path, pt_dir)
    rec['fof']['seconds'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['particles'] = dist_particles_rank(mesh, pt_dir)
    rec['particles']['seconds'] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rec['groups'] = dist_groups_rank(mesh, pt_dir)
    rec['groups']['seconds'] = time.perf_counter() - t1
    if nproc in DTK_RANKS:
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec['tasks'] = dist_tasks_rank(mesh)
        rec['tasks']['seconds'] = time.perf_counter() - t1
    rec['rank_seconds'] = time.perf_counter() - t_start
    q.put(rec)
    torch.distributed.destroy_process_group()


def staged_run(fn, comm=None):
    """(fn's result, its record): one call of ``fn`` with every kernel's
    launches counted, ``utils.stage_timer`` set (a CUDA-event window a
    stage), its CUDA-event time and the peak memory allocated. With a
    ``comm`` the ranks start together (one all_reduce first), so a
    rank's window does not hold its wait for a late rank."""
    from nbodykit_tpu_torch import utils
    if comm is not None:
        comm.all_reduce(torch.zeros(1, device=comm.device))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = StageTimes()
    utils.stage_timer = times
    try:
        with counted_launches() as launches:
            out, ms = timed(fn)
    finally:
        utils.stage_timer = None
    stages = {k: {'total': float(sum(v)), 'calls': len(v)}
              for k, v in times.ms.items()}
    return out, dict(ms=ms, stages_ms=stages, launches=launches,
                     peak_bytes=torch.cuda.max_memory_allocated())


def slab_payload(mesh, pm, cpos, mass):
    """This rank's particles, in cell units, and masses exchanged to
    the owners of their slabs (a collective): (positions, masses) of
    the rows this rank receives, pads at mass 0."""
    from nbodykit_tpu_torch.parallel.exchange import exchange_by_dest
    dest = pm._route_dest(cpos).contiguous()
    (cpos_r, mass_r), valid, _ = exchange_by_dest(dest, [cpos, mass], mesh)
    return cpos_r, torch.where(valid, mass_r, 0.0)


def slab_deposit(label, pm, cpos_r, mass_r, resampler, stripes=None):
    """Rank 0's deposit on its extended slab against its plain version
    (on ``stripes`` x-stripes when given, as convpower_kernels does),
    and its time beside its bound: the whole payload's, and the
    stripes' with the plain version's. Returns ({record}, lines)."""
    from nbodykit_tpu_torch.ops.window import window_support
    h = window_support(resampler)
    N = int(pm.Nmesh[0])
    n0 = N // pm.nproc
    (plan, payload, geom, err, _), lines = _quiet(
        deposit_case, '%s slab n0l=%d origin=%d of %d^3, rank 0 of %d: %s'
        % (resampler, n0 + 2 * h, -h, N, pm.nproc, label), cpos_r, mass_r,
        (n0 + 2 * h, N, N), (N,) * 3, -h, resampler, stripes=stripes)
    recs = {label: time_deposit(payload, geom, plan, err,
                                plain=stripes is None)}
    if stripes:
        sub = tuple(a[:stripes].contiguous() for a in payload)
        recs['%s_%d_stripes' % (label, stripes)] = time_deposit(
            sub, geom, plan, err)
    return recs, lines


def exchange_rank_check(mesh, pm, cpos):
    """The exchange's rank pass at D = P on this rank's destinations
    against its plain version, bit for bit; rank 0 also times it.
    Returns (bit-identical, rank 0's time record or None, lines)."""
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   raise_on_bad_digits)
    dest = pm._route_dest(cpos).contiguous()
    got = pass_rank_hist_cuda(dest, mesh.size)
    raise_on_bad_digits(pm.device)
    want = pass_rank_hist_plain(dest, mesh.size)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    assert same, "rank %d: the exchange's rank pass differs" % mesh.rank
    del got, want
    if mesh.rank != 0:
        return same, None, []
    rec, lines = _quiet(time_rank, dest.shape[0], D=mesh.size,
                        digits=dest, plain_reps=1)
    return same, rec, lines


def dist_convpower_rank(mesh):
    """One rank of ``dist_convpower``: the convpower flow's Data and
    Algorithm on this rank's rows at DCP_NMESH, once, staged; its gates;
    the exchange's rank pass on its randoms' destinations; rank 0's TSC
    f8 deposit on its extended slab, for the data and on DIST_STRIPES
    stripes of the randoms."""
    mesh_cp, data_rec = staged_run(lambda: convpower_data(DCP_NMESH, mesh),
                                   mesh)
    r, alg_rec = staged_run(lambda: convpower_algorithm(mesh_cp), mesh)
    # two paints, each an exchange (a rank pass at D = P) and bucket
    # passes; four catalog draws
    for name, want in (('paint_deposit', 2), ('radix_rank', 4)):
        assert alg_rec['launches'][name] >= want, alg_rec['launches']
    assert data_rec['launches']['threefry_fill'] >= 4, data_rec['launches']
    out = dict(data=data_rec, algorithm=alg_rec,
               gates=convpower_gates(r, mesh_cp, DCP_NMESH),
               poles={c: np.asarray(r.poles[c]) for c in r.poles.variables},
               attrs={k: r.attrs[k] for k in DCP_SCALARS},
               box=mesh_cp.attrs['BoxSize'].tolist(),
               box_center=mesh_cp.attrs['BoxCenter'].tolist(),
               n_rows={n: len(mesh_cp.source[n])
                       for n in ('data', 'randoms')}, lines=[])
    del r
    kernels = {}
    for name, stripes in (('data', None), ('randoms', DIST_STRIPES)):
        sm = mesh_cp[name]
        cpos = sm.pm._to_cell_units(sm.source[sm.position])
        if name == 'randoms':
            same, rank_rec, lines = exchange_rank_check(mesh, sm.pm, cpos)
            out['rank_pass_bit_identical'] = same
            out['lines'] += lines
            kernels['rank'] = rank_rec
        cpos_r, mass_r = slab_payload(
            mesh, sm.pm, cpos, sm.source[sm.weight].to(torch.float64))
        del cpos
        if mesh.rank == 0:
            recs, lines = slab_deposit(name, sm.pm, cpos_r, mass_r, 'tsc',
                                       stripes=stripes)
            kernels.update(recs)
            out['lines'] += lines
        del cpos_r, mass_r, sm
        torch.cuda.empty_cache()
    out['kernels'] = kernels
    return out


def dist_recon_rank(mesh, pos_path, ref_path):
    """One rank of ``dist_recon``: the FFTRecon flow on this rank's rows
    of the positions at ``pos_path`` (an ArrayCatalog) and of ~1e8
    uniform randoms (seed 84), once, staged; the field gathered to rank
    0 and held against the one-rank field at ``ref_path``; rank 0's CIC
    f4 deposit on its extended slab of the shifted randoms (on
    DIST_STRIPES stripes against the plain version)."""
    from nbodykit_tpu_torch.source.catalog import (ArrayCatalog,
                                                   UniformCatalog)
    from nbodykit_tpu_torch.utils import GatherArray
    data = ArrayCatalog({'Position': np.load(pos_path)},
                        comm=mesh, BoxSize=LN_BOX)
    randoms = UniformCatalog(nbar=10 * LN_N / LN_BOX ** 3, BoxSize=LN_BOX,
                             seed=84, comm=mesh)
    randoms['Position']
    (recon, field, p), rec = staged_run(lambda: fftrecon_run(data, randoms),
                                        mesh)
    # three paints (data, shifted randoms, shifted data), each an exchange
    # and bucket passes
    for name, want in (('paint_deposit', 3), ('radix_rank', 6)):
        assert rec['launches'][name] >= want, rec['launches']
    value = field.value
    pm = recon.pm
    out = dict(run=rec, n_rows=(len(data), len(randoms)),
               power={c: np.asarray(p.power[c])
                      for c in p.power.variables},
               field_mean=float(mesh.all_reduce(value.double().sum()))
               / pm.Ntot, lines=[])
    whole = GatherArray(value, mesh, root=0)
    if mesh.rank == 0:
        ref = np.load(ref_path, mmap_mode='r')
        assert whole.shape == ref.shape, whole.shape
        out['field_max_abs_diff'] = float(np.abs(whole - ref).max())
        out['field_max'] = float(np.abs(ref).max())
    del whole, field, value, p
    # the shifted randoms the second paint deposits
    s_r = recon._compute_s()[1]
    cpos = pm._to_cell_units(randoms['Position'].to(torch.float32) - s_r)
    del s_r
    cpos_r, mass_r = slab_payload(
        mesh, pm, cpos, torch.ones(len(randoms), dtype=torch.float32,
                                   device=pm.device))
    del cpos
    if mesh.rank == 0:
        out['kernels'], out['lines'] = slab_deposit(
            'shifted_randoms', pm, cpos_r, mass_r, 'cic',
            stripes=DIST_STRIPES)
    return out


def dist_bispectrum_rank(mesh):
    """One rank of ``dist_bispectrum``: the bispectrum path's flow on
    this rank's rows, once, staged; the exchange's rank pass on its
    destinations; rank 0's f8 CIC deposit on its extended slab."""
    (cat, b), rec = staged_run(lambda: bispectrum_flow(comm=mesh), mesh)
    # the paint's exchange and bucket pass, its deposit; the draws
    for name, want in (('paint_deposit', 1), ('radix_rank', 2),
                       ('threefry_fill', 1)):
        assert rec['launches'][name] >= want, rec['launches']
    rec['memory_plan_peak_gb'] = bispectrum_plan(cat.csize, mesh.size)
    out = dict(run=rec, n_rows=len(cat), B=np.asarray(b.B['B']),
               ntri=np.asarray(b.B['ntri']), lines=[])
    del b
    pm = cat.to_mesh(Nmesh=BS_NMESH, dtype='f8', compensated=True).pm
    cpos = pm._to_cell_units(cat['Position'])
    same, out['rank'], lines = exchange_rank_check(mesh, pm, cpos)
    out['rank_pass_bit_identical'] = same
    out['lines'] += lines
    cpos_r, mass_r = slab_payload(
        mesh, pm, cpos, torch.ones(len(cat), dtype=torch.float64,
                                   device=pm.device))
    del cpos, cat
    if mesh.rank == 0:
        recs, lines = slab_deposit('bispectrum', pm, cpos_r, mass_r, 'cic')
        out['deposit'] = recs['bispectrum']
        out['lines'] += lines
    return out


def dist_bispectrum_reference():
    """The one-rank run of dist_bispectrum's configuration, staged as a
    rank's: B, ntri and its record."""
    (cat, b), rec = staged_run(bispectrum_flow)
    rec['memory_plan_peak_gb'] = bispectrum_plan(len(cat))
    ref = dict(run=rec, B=np.asarray(b.B['B']), ntri=np.asarray(b.B['ntri']),
               npart=len(cat))
    del cat, b
    torch.cuda.empty_cache()
    return ref


def forward_model(comm=None):
    """The forward path's model (FW_*), on ``comm``'s ranks."""
    from nbodykit_tpu_torch.forward import ForwardModel
    return ForwardModel(FW_NMESH, FW_NMESH ** 3, BoxSize=1000.0,
                        pm_steps=FW_STEPS, delta_rms=FW_DELTA_RMS,
                        dtype='f8', comm=comm)


def forward_runs(model, obs, w0, comm=None):
    """The forward path's runs, each staged: the density of the truth
    modes (seed 0), one value and gradient of the loss at the linear
    start ``w0``, DFW_ADAM_STEPS of recover from it. Returns (density,
    loss, gradient, Adam losses, {records})."""
    from nbodykit_tpu_torch.forward import make_loss, recover

    def density():
        with torch.no_grad():
            return model.density(model.linear_modes(0))
    dens, d_rec = staged_run(density, comm)
    loss = make_loss(model, obs, noise_std=FW_NOISE)

    def value_and_grad():
        x = w0.clone().requires_grad_(True)
        val = loss(x)
        return float(val), torch.autograd.grad(val, x)[0]
    (val, grad), vg_rec = staged_run(value_and_grad, comm)
    (_, losses), adam_rec = staged_run(lambda: recover(
        model, obs, steps=DFW_ADAM_STEPS, lr=FW_LR, noise_std=FW_NOISE,
        white0=w0), comm)
    # the truth's draw; across ranks every paint and readout is routed
    # by the rank pass (grad mode's scatter paint deposits no mxu blocks)
    assert d_rec['launches']['threefry_fill'] >= 1, d_rec['launches']
    if comm is not None:
        assert vg_rec['launches']['radix_rank'] >= 1, vg_rec['launches']
    return dens, val, grad, losses, dict(density=d_rec, value_and_grad=vg_rec,
                                         adam=adam_rec)


def dist_forward_reference(fw_dir):
    """The one-rank run of dist_forward's configuration: the truth's
    density (the observation) and the linear start saved in ``fw_dir``
    for the ranks, the density and gradient saved for rank 0's checks;
    the loss, Adam's losses and the records."""
    from nbodykit_tpu_torch.forward import linear_init
    model = forward_model()
    with torch.no_grad():
        obs = model.density(model.linear_modes(0))
        w0 = linear_init(model, obs)
    dens, val, grad, losses, recs = forward_runs(model, obs, w0)
    for name, t in (('obs', obs), ('w0', w0), ('density', dens),
                    ('grad', grad)):
        np.save(os.path.join(fw_dir, name + '.npy'), t.cpu().numpy())
    ref = dict(value=val, adam_losses=losses, runs=recs,
               memory_plan_peak_gb=forward_plan())
    del model, obs, w0, dens, grad
    torch.cuda.empty_cache()
    return ref


def dist_forward_rank(mesh, fw_dir):
    """One rank of ``dist_forward``: the forward path's model on this
    rank's slabs (the one-rank observation and linear start from
    ``fw_dir``), its density, value and gradient and Adam steps, staged;
    the density and the gradient gathered to rank 0 and held against
    the one-rank arrays; at P = 2 forward_fd_check across the ranks;
    the exchange's rank pass on the destinations of the first paint."""
    from nbodykit_tpu_torch import convert
    from nbodykit_tpu_torch.forward import lpt_init
    from nbodykit_tpu_torch.utils import GatherArray
    model = forward_model(mesh)
    pm = model.pm
    obs = torch.as_tensor(np.load(os.path.join(fw_dir, 'obs.npy'),
                                  mmap_mode='r')[pm._rows(FW_NMESH)],
                          device=pm.device)
    w0 = convert.white_from_numpy(np.load(os.path.join(fw_dir, 'w0.npy')),
                                  model)
    dens, val, grad, losses, runs = forward_runs(model, obs, w0, mesh)
    for r in runs.values():
        r['memory_plan_peak_gb'] = forward_plan(mesh.size)
    out = dict(value=val, adam_losses=losses, runs=runs, lines=[])
    for name, t in (('density', dens), ('grad', grad)):
        whole = GatherArray(t, mesh, root=0)
        if mesh.rank == 0:
            ref = np.load(os.path.join(fw_dir, name + '.npy'))
            out[name + '_max_abs_diff'] = float(np.abs(whole - ref).max())
            out[name + '_max'] = float(np.abs(ref).max())
        del whole
    del dens, grad
    if mesh.size == 2:
        out['fd_check'] = forward_fd_check(comm=mesh)
    # the first paint's particles: the LPT positions of the linear start
    with torch.no_grad():
        pos, _ = lpt_init(model.lattice, model.modes_from_white(w0),
                          a=model.a_start, order=model.order,
                          growth=model.growth)
        cpos = pm._to_cell_units(pos)
    same, out['rank'], lines = exchange_rank_check(mesh, pm, cpos)
    out['rank_pass_bit_identical'] = same
    out['lines'] += lines
    return out


def dist_slice_phases(nproc, backend, recs, bs_ref, fw_ref):
    """The parent's checks of dist_bispectrum and dist_forward at
    ``nproc`` ranks against the one-rank runs, and their lines. Returns
    ({'dist_bispectrum_P<n>': launches, 'dist_forward_P<n>': ...} summed
    over the ranks, rank 0's kernel records)."""
    bss = [rec['bispectrum'] for rec in recs]
    fws = [rec['forward'] for rec in recs]
    for c in bss + fws:
        for line in c.pop('lines'):
            emit(dict(line, dist_ranks=nproc))
    closed = ~np.isnan(bs_ref['B'])
    b_worst = 0.0
    for c in bss:
        assert np.array_equal(np.nan_to_num(c['ntri'], nan=-1.0),
                              np.nan_to_num(bs_ref['ntri'], nan=-1.0)), \
            "dist_bispectrum P=%d: ntri differs from one rank's" % nproc
        assert np.array_equal(np.isnan(c['B']), ~closed)
        d = float(np.max(np.abs(c['B'][closed] / bs_ref['B'][closed] - 1)))
        assert d <= DBS_B_RTOL, "dist_bispectrum P=%d: B %g" % (nproc, d)
        b_worst = max(b_worst, d)
    assert sum(c['n_rows'] for c in bss) == bs_ref['npart']
    f0 = fws[0]
    assert f0['density_max_abs_diff'] <= \
        DFW_DENSITY_RTOL * f0['density_max'], f0
    assert f0['grad_max_abs_diff'] <= DFW_GRAD_RTOL * f0['grad_max'], f0
    loss_worst = max(abs(c['value'] / fw_ref['value'] - 1) for c in fws)
    assert loss_worst <= DFW_LOSS_RTOL, loss_worst
    adam_worst = max(float(np.max(np.abs(np.asarray(c['adam_losses'])
                                         / fw_ref['adam_losses'] - 1)))
                     for c in fws)
    assert adam_worst <= DFW_ADAM_RTOL, adam_worst
    assert nproc != 2 or f0['fd_check']['rel_err'] <= FD_RTOL

    def summed(runs):
        return {k: sum(run['launches'][k] for run in runs)
                for k in runs[0]['launches']}
    launches = {
        'dist_bispectrum_P%d' % nproc: summed([c['run'] for c in bss]),
        'dist_forward_P%d' % nproc: summed([r for c in fws
                                            for r in c['runs'].values()])}
    setting = DIST_SETTINGS[backend]
    emit({'phase': 'dist_bispectrum', 'ranks': nproc, 'nmesh': BS_NMESH,
          'nbins': BS_NBINS, 'backend': backend, 'setting': setting,
          'B_max_rel_diff_vs_one_rank': b_worst, 'B_rtol': DBS_B_RTOL,
          'ntri_identical': True, 'closed_cells': int(closed.sum()),
          'one_rank': bs_ref['run'],
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            run=c['run'], seconds=c['seconds'],
                            rank_pass_bit_identical=c[
                                'rank_pass_bit_identical'])
                       for rec, c in zip(recs, bss)],
          'kernels_rank0': {k: bss[0][k] for k in ('rank', 'deposit')}})
    emit({'phase': 'dist_forward', 'ranks': nproc, 'nmesh': FW_NMESH,
          'pm_steps': FW_STEPS, 'backend': backend, 'setting': setting,
          'density_max_abs_diff_vs_one_rank': f0['density_max_abs_diff'],
          'density_max': f0['density_max'],
          'density_rtol': DFW_DENSITY_RTOL,
          'loss_max_rel_diff_vs_one_rank': loss_worst,
          'loss_rtol': DFW_LOSS_RTOL,
          'grad_max_abs_diff_vs_one_rank': f0['grad_max_abs_diff'],
          'grad_max': f0['grad_max'], 'grad_rtol': DFW_GRAD_RTOL,
          'adam_steps': DFW_ADAM_STEPS,
          'adam_losses_max_rel_diff_vs_one_rank': adam_worst,
          'adam_rtol': DFW_ADAM_RTOL, 'fd_check': f0.get('fd_check'),
          'one_rank': dict(fw_ref['runs'],
                           memory_plan_peak_gb=fw_ref['memory_plan_peak_gb']),
          'per_rank': [dict(rank=rec['rank'], runs=c['runs'],
                            seconds=c['seconds'],
                            rank_pass_bit_identical=c[
                                'rank_pass_bit_identical'])
                       for rec, c in zip(recs, fws)],
          'kernels_rank0': {'rank': f0['rank']}})
    kernels = dict(bs_rank=bss[0]['rank'], bs_deposit=bss[0]['deposit'],
                   fw_rank=f0['rank'])
    return launches, kernels


def route_rank_check(mesh, dest, times=None):
    """The exchange's rank pass at D = P on a route's destinations
    against its plain version, bit for bit; rank 0 (or, given, the ranks
    where ``times``) also times it beside ``torch.argsort``. Returns
    (bit-identical, the timing record or None, lines)."""
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain,
                                                   raise_on_bad_digits)
    dest = torch.clamp(dest.to(torch.int32), 0, mesh.size - 1).contiguous()
    got = pass_rank_hist_cuda(dest, mesh.size)
    raise_on_bad_digits(dest.device)
    want = pass_rank_hist_plain(dest, mesh.size)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    assert same, "rank %d: the route's rank pass differs" % mesh.rank
    del got, want
    if not (mesh.rank == 0 if times is None else times):
        return same, None, []
    rec, lines = _quiet(time_rank, dest.shape[0], D=mesh.size, digits=dest,
                        plain_reps=1)
    return same, rec, lines


def links_sweep_check(where, row, links):
    """The links sweep (``fof_links_sweep``) of the first sweep on a
    link list against its plain version, bit for bit; its time beside
    its byte bound and one ``scatter_reduce`` of the same min."""
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    n = row.shape[0] - 1
    lab = torch.arange(n, dtype=torch.int32, device='cuda')
    got = fc.fof_links_sweep_cuda(row, links, lab)
    want, plain_ms = timed(lambda: fc.fof_links_sweep_plain(row, links, lab))
    assert torch.equal(got, want), "%s: the links sweep differs" % where
    ms = cuda_ms(lambda: fc.fof_links_sweep_cuda(row, links, lab), reps=20)
    owner = torch.repeat_interleave(torch.arange(n, device='cuda'),
                                    row[1:] - row[:-1])
    vals = lab[links.long()]
    lib_ms = cuda_ms(lambda: lab.scatter_reduce(0, owner, vals, 'amin'),
                     reps=20)
    E = int(row[-1])
    b_ms, b_by = bound(fc.links_sweep_bytes(n, E), 0, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0, share_of_bound=b_ms / ms,
                at='%s n=%d, E=%d' % (where, n, E))


def halo_roots(labels, nhalo):
    """Each halo's least member index (labels on the card, halos 1 ..
    nhalo): its canonical name, independent of the label order."""
    idx = torch.arange(labels.shape[0], device=labels.device)
    first = torch.full((nhalo + 1,), labels.shape[0], dtype=torch.int64,
                       device=labels.device)
    return first.scatter_reduce(0, labels, idx, 'amin')[1:]


def least_member(roots):
    """Each particle's group named by its least member index; ``roots``
    names each particle's group by any one member's index."""
    r = roots.long()
    idx = torch.arange(r.shape[0], device=r.device)
    first = torch.full_like(r, r.shape[0]).scatter_reduce(0, r, idx, 'amin')
    return first[r]


@contextlib.contextmanager
def captured_fof_roots():
    """[roots] that FOF's root-label calls return inside, in order: the
    one-device ``_fof_labels`` and the slab branch's
    ``_fof_labels_distributed``, each particle's group before the nmin
    cut. The functions are called through and put back on exit."""
    from nbodykit_tpu_torch.algorithms import fof as fof_module
    names = ('_fof_labels', '_fof_labels_distributed')
    origs = {name: getattr(fof_module, name) for name in names}
    roots = []

    def spy(orig):
        def call(*a, **kw):
            out = orig(*a, **kw)
            roots.append(out)
            return out
        return call
    for name, orig in origs.items():
        setattr(fof_module, name, spy(orig))
    try:
        yield roots
    finally:
        for name, orig in origs.items():
            setattr(fof_module, name, orig)


def dist_fof_catalog(pos_path, comm=None):
    """The FOF flow's lognormal catalog from the positions and
    velocities the parent saved (``pos_path``, and its ``_velocity``
    twin), on ``comm``'s ranks (this rank's rows) or on one rank."""
    from nbodykit_tpu_torch.source.catalog import ArrayCatalog
    cols = {'Position': np.load(pos_path),
            'Velocity': np.load(pos_path.replace('.npy', '_velocity.npy'))}
    if comm is None:
        return ArrayCatalog(cols, BoxSize=LN_BOX, device='cuda')
    return ArrayCatalog(cols, BoxSize=LN_BOX, comm=comm)


def dist_fof_reference(pos_path, pt_dir):
    """The one-rank run of dist_fof's configuration, staged as a rank's:
    its groups before the nmin cut (``least_member``), labels and halo
    columns saved in ``pt_dir`` for rank 0's checks; its record."""
    cat = dist_fof_catalog(pos_path)
    with captured_fof_roots() as roots:
        (fof, halos, _), rec = staged_run(lambda: fof_algorithm(cat))
    assert len(roots) == 1, len(roots)
    whole = least_member(roots[0])
    idx = torch.arange(whole.shape[0], device=whole.device)
    groups = int((whole == idx).sum())
    linked = int((torch.bincount(whole) >= 2).sum())
    np.save(os.path.join(pt_dir, 'fof_roots.npy'),
            whole.to(torch.int32).cpu().numpy())
    del roots, whole, idx
    np.save(os.path.join(pt_dir, 'fof_labels.npy'), fof.labels.cpu().numpy())
    np.savez(os.path.join(pt_dir, 'fof_halos.npz'), **{
        c: halos[c].cpu().numpy() for c in ('Mass', 'Position', 'Velocity')})
    ref = dict(run=rec, nhalo=fof._halo_count, n_rows=len(cat),
               groups=groups, groups_of_2_or_more=linked,
               sweeps=fof.sweeps, links=fof.links, branch=fof.branch)
    del cat, fof, halos
    torch.cuda.empty_cache()
    return ref


def dist_fof_gates(roots, labels, cols, pt_dir):
    """Rank 0's checks of the gathered FOF run against the one-rank run
    saved in ``pt_dir``: every particle's root before the nmin cut (the
    slab branch's least global index of its group) equal to the one-rank
    group's least member, so every group of any size is the same; the
    halo count and the halos' Mass (Length
    times the particle mass, in descending order) identical, the same
    partition (each grouped particle named by its halo's least member),
    and each halo, matched by that name, within DFOF_CM_TOL (Position,
    the centre of mass, minimum image) and DFOF_VEL_RTOL (Velocity)."""
    whole = np.load(os.path.join(pt_dir, 'fof_roots.npy'))
    assert roots.shape == whole.shape, (roots.shape, whole.shape)
    assert np.array_equal(roots.astype('i8'), whole), \
        "dist_fof: the groups before the nmin cut differ from one rank's"
    del whole
    ref = np.load(os.path.join(pt_dir, 'fof_halos.npz'))
    nhalo = len(ref['Mass'])
    assert len(cols['Mass']) == nhalo, (len(cols['Mass']), nhalo)
    assert np.array_equal(cols['Mass'], ref['Mass'])
    got = torch.as_tensor(labels, device='cuda')
    one = torch.as_tensor(np.load(os.path.join(pt_dir, 'fof_labels.npy')),
                          device='cuda')
    assert got.shape == one.shape, (got.shape, one.shape)
    roots_g, roots_1 = halo_roots(got, nhalo), halo_roots(one, nhalo)
    pad = torch.full((1,), -1, dtype=torch.int64, device='cuda')
    assert torch.equal(torch.cat([pad, roots_g])[got],
                       torch.cat([pad, roots_1])[one]), \
        "dist_fof: the partition differs from one rank's"
    del got, one
    og = torch.argsort(roots_g).cpu().numpy()
    o1 = torch.argsort(roots_1).cpu().numpy()
    assert torch.equal(roots_g.sort().values, roots_1.sort().values)
    d = np.abs(cols['Position'][og].astype('f8')
               - ref['Position'][o1].astype('f8'))
    cm = float(np.minimum(d, LN_BOX - d).max())
    dv = float(np.abs(cols['Velocity'][og].astype('f8')
                      - ref['Velocity'][o1].astype('f8')).max())
    vmax = float(np.abs(ref['Velocity']).max())
    assert cm <= DFOF_CM_TOL, ("dist_fof CMPosition", cm)
    assert dv <= DFOF_VEL_RTOL * vmax, ("dist_fof CMVelocity", dv, vmax)
    return dict(halos=nhalo, roots_identical=True, length_identical=True,
                partition_identical=True,
                cm_position_max_abs_diff=cm, cm_position_tol=DFOF_CM_TOL,
                cm_velocity_max_abs_diff=dv, cm_velocity_max=vmax,
                cm_velocity_rtol=DFOF_VEL_RTOL)


def dist_fof_rank(mesh, pos_path, pt_dir):
    """One rank of ``dist_fof``: the FOF flow's Algorithm (FOF, to_halos)
    on this rank's rows, once, staged, on the slab branch; the labels and
    halo columns gathered to rank 0 and held against the one-rank run
    (``dist_fof_gates``), the roots before the nmin cut too; the route's
    rank pass at D = P; on rank 0's
    routed particles the link count, the link fill and the links sweep
    against their plain versions, timed beside their bounds."""
    from nbodykit_tpu_torch.parallel.domain import slab_route
    from nbodykit_tpu_torch.utils import GatherArray
    cat = dist_fof_catalog(pos_path, mesh)
    with captured_link_calls() as link_calls, \
            captured_fof_roots() as roots:
        (fof, halos, _), rec = staged_run(lambda: fof_algorithm(cat), mesh)
    assert fof.branch == 'slab', fof.branch
    assert len(roots) == 1, len(roots)
    # the route's exchange and the local grid's passes; one link count,
    # one fill, the links sweeps; the merge rounds' exchanges
    for name, want in (('radix_rank', 2), ('fof_link_count', 1),
                       ('fof_link_fill', 1), ('fof_sweep_links', 1)):
        assert rec['launches'][name] >= want, rec['launches']
    out = dict(run=rec, n_rows=len(cat), nhalo=fof._halo_count,
               branch=fof.branch, merge_rounds=fof.merge_rounds,
               sweeps=fof.sweeps, links=fof.links, lines=[])
    whole = GatherArray(roots[0], mesh, root=0)
    labels = GatherArray(fof.labels, mesh, root=0)
    cols = {c: GatherArray(halos[c], mesh, root=0)
            for c in ('Mass', 'Position', 'Velocity')}
    if mesh.rank == 0:
        out['gates'] = dist_fof_gates(whole, labels, cols, pt_dir)
    del whole, roots, labels, cols, halos
    route, _, _ = slab_route(cat['Position'], fof.attrs['BoxSize'], fof._ll,
                             mesh, ghosts='down', balance=True)
    same, out['rank'], lines = route_rank_check(mesh, route.dest)
    out['rank_pass_bit_identical'] = same
    out['lines'] += lines
    del route, cat, fof
    if mesh.rank == 0:
        names = [c[0] for c in link_calls]
        assert names == ['fof_link_count_cuda', 'fof_link_fill_cuda'], names
        a = link_calls[0][1]
        where = 'dist_fof rank 0 of %d' % mesh.size
        (recs, row, links, _), lines = _quiet(
            link_kernel_checks, where, a[:4], a[4], a[5:10], turns=False)
        out['lines'] += lines
        recs['fof_sweep'] = links_sweep_check(where, row, links)
        out['kernels'] = recs
    del link_calls
    return out


def dist_particle_catalogs(pt_dir, comm=None):
    """The boss_like catalog (Position, Weight, Mass), its randoms and the
    catalog on the sky (``sky_catalog`` of the whole catalog), from the
    arrays the parent saved in ``pt_dir``, on ``comm``'s ranks or on
    one rank."""
    from nbodykit_tpu_torch.source.catalog import ArrayCatalog
    load = lambda name: np.load(os.path.join(pt_dir, name + '.npy'))  # noqa
    whole = ArrayCatalog({'Position': load('pb_position'),
                          'Weight': load('pb_weight')}, BoxSize=PB_BOX,
                         device='cuda')
    sky = sky_catalog(whole)
    kw = dict(device='cuda') if comm is None else dict(comm=comm)
    cat = ArrayCatalog({'Position': whole['Position'],
                        'Weight': whole['Weight'],
                        'Mass': load('pb_mass')}, BoxSize=PB_BOX, **kw)
    randoms = ArrayCatalog({'Position': load('pb_randoms')}, BoxSize=PB_BOX,
                           **kw)
    dsky = ArrayCatalog({c: sky[c] for c in ('RA', 'DEC', 'Redshift',
                                             'Weight')}, **kw)
    return cat, randoms, dsky


def dist_particles_run(cat, randoms, dsky):
    """The particle statistics of dist_particles through the user entry
    points: the box 1d auto and cross counts, the survey's 2d midpoint
    DD, KDDensity and a sort on the Weight column."""
    from nbodykit_tpu_torch.cosmology import Planck15
    from nbodykit_tpu_torch.lab import (KDDensity, SimulationBoxPairCount,
                                        SurveyDataPairCount)
    return dict(
        box_1d=SimulationBoxPairCount('1d', cat, PB_EDGES),
        box_cross_1d=SimulationBoxPairCount('1d', cat, PB_EDGES,
                                            second=randoms),
        survey_DD=SurveyDataPairCount('2d', dsky, PB_EDGES, cosmo=Planck15,
                                      Nmu=10),
        kddensity=KDDensity(cat), sorted=cat.sort('Weight'))


def particle_counts(res):
    """{count: npairs, wnpairs, the weight totals, the branch}."""
    keys = ('total_wnpairs', 'W1', 'W2', 'N1', 'N2')
    return {c: dict(npairs=np.asarray(res[c].pairs['npairs']),
                    wnpairs=np.asarray(res[c].pairs['wnpairs']),
                    branch=res[c].branch,
                    **{k: res[c].attrs[k] for k in keys})
            for c in DPC_COUNTS}


def dist_particles_reference(pt_dir):
    """The boss_like catalogs made and saved in ``pt_dir`` for the ranks,
    and the one-rank run of dist_particles on them, staged as a rank's:
    the counts, and the densities and the sorted catalog saved for rank
    0's checks."""
    cat, randoms = particles_catalogs()
    for name, t in (('pb_position', cat['Position']),
                    ('pb_weight', cat['Weight']),
                    ('pb_mass', cat['Mass']),
                    ('pb_randoms', randoms['Position'])):
        np.save(os.path.join(pt_dir, name + '.npy'), t.cpu().numpy())
    del cat, randoms
    cats = dist_particle_catalogs(pt_dir)
    res, rec = staged_run(lambda: dist_particles_run(*cats))
    np.save(os.path.join(pt_dir, 'pb_density.npy'),
            res['kddensity'].density.cpu().numpy())
    for c in ('Position', 'Weight'):
        np.save(os.path.join(pt_dir, 'pb_sorted_%s.npy' % c),
                res['sorted'][c].cpu().numpy())
    ref = dict(run=rec, counts=particle_counts(res), n_rows=len(cats[0]))
    del cats, res
    torch.cuda.empty_cache()
    return ref


def dist_particles_rank(mesh, pt_dir):
    """One rank of ``dist_particles``: the run on this rank's rows, once,
    staged; the densities and the sorted catalog gathered to rank 0 and
    held against the one-rank run, bit for bit; the rank pass of the
    1d count's route of primaries at D = P; on rank 0's routed particles
    each pair count's kernel against its plain version on a query
    sample (``pair_shape``) and KDDensity's link count on every query,
    timed beside their bounds."""
    from nbodykit_tpu_torch.parallel.domain import slab_route
    from nbodykit_tpu_torch.utils import GatherArray
    cats = dist_particle_catalogs(pt_dir, mesh)
    with captured_pair_counts() as calls, \
            captured_link_calls() as link_calls:
        res, rec = staged_run(lambda: dist_particles_run(*cats), mesh)
    for name, want in (('paircount_hist', len(DPC_COUNTS)),
                       ('fof_link_count', 1), ('radix_rank', 6)):
        assert rec['launches'][name] >= want, rec['launches']
    counts = particle_counts(res)
    assert all(c['branch'] == 'slab' for c in counts.values()), counts
    assert res['kddensity'].branch == 'slab'
    out = dict(run=rec, n_rows=len(cats[0]), counts=counts,
               kddensity_branch=res['kddensity'].branch, lines=[])
    density = GatherArray(res['kddensity'].density, mesh, root=0)
    srt = {c: GatherArray(res['sorted'][c], mesh, root=0)
           for c in ('Position', 'Weight')}
    if mesh.rank == 0:
        load = lambda name: np.load(os.path.join(pt_dir, name + '.npy'))  # noqa
        assert np.array_equal(density, load('pb_density')), \
            "dist_particles: KDDensity differs from one rank's"
        for c, v in srt.items():
            assert np.array_equal(v, load('pb_sorted_%s' % c)), \
                "dist_particles: the sorted %s differs" % c
        out['density_identical'] = out['sorted_identical'] = True
    del res, density, srt
    route, _, _ = slab_route(cats[0]['Position'].double(), PB_BOX,
                             PB_EDGES[-1], mesh, ghosts=None, balance=True)
    same, out['rank'], lines = route_rank_check(mesh, route.dest)
    out['rank_pass_bit_identical'] = same
    out['lines'] += lines
    del route, cats
    if mesh.rank == 0:
        assert len(calls) == len(DPC_COUNTS), len(calls)
        shapes = []
        for label, call in zip(DPC_COUNTS, calls):
            shape, lines = _quiet(pair_shape, 'dist %s rank 0 of %d'
                                  % (label, mesh.size), call)
            shapes.append(shape)
            out['lines'] += lines
        (_, a, _), = link_calls
        (recs, *_), lines = _quiet(
            link_kernel_checks, 'dist kddensity rank 0 of %d' % mesh.size,
            a[:4], a[4], a[5:10], fill=False, turns=False)
        out['lines'] += lines
        out['kernels'] = dict(pairs=shapes, kddensity=recs['fof_link_count'])
    del calls, link_calls
    return out


def dist_particle_phases(nproc, backend, recs, fof_ref, pt_ref):
    """The parent's checks of dist_fof and dist_particles at ``nproc``
    ranks against the one-rank runs, and their lines. Returns
    ({'dist_fof_P<n>': launches, 'dist_particles_P<n>': ...} summed over
    the ranks, rank 0's kernel records)."""
    fofs = [rec['fof'] for rec in recs]
    pts = [rec['particles'] for rec in recs]
    for c in fofs + pts:
        for line in c.pop('lines'):
            emit(dict(line, dist_ranks=nproc))
    assert sum(c['n_rows'] for c in fofs) == fof_ref['n_rows']
    assert all(c['nhalo'] == fof_ref['nhalo'] for c in fofs)
    assert sum(c['n_rows'] for c in pts) == pt_ref['n_rows']
    worst = 0.0
    for c in pts:
        for name, want in pt_ref['counts'].items():
            got = c['counts'][name]
            assert np.array_equal(got['npairs'], want['npairs']), \
                "dist_particles P=%d %s: npairs differ" % (nproc, name)
            d = float(np.max(np.abs(got['wnpairs'] - want['wnpairs'])
                             / np.maximum(np.abs(want['wnpairs']), 1e-300)))
            for k in ('total_wnpairs', 'W1', 'W2'):
                d = max(d, abs(got[k] / want[k] - 1))
            assert d <= DPC_RTOL, (name, d)
            assert (got['N1'], got['N2']) == (want['N1'], want['N2'])
            worst = max(worst, d)
    setting = DIST_SETTINGS[backend]

    def summed(runs):
        return {k: sum(run['launches'][k] for run in runs)
                for k in runs[0]['launches']}
    launches = {'dist_fof_P%d' % nproc: summed([c['run'] for c in fofs]),
                'dist_particles_P%d' % nproc: summed([c['run']
                                                      for c in pts])}
    f0, p0 = fofs[0], pts[0]
    emit({'phase': 'dist_fof', 'ranks': nproc, 'box': LN_BOX,
          'linking_length': FOF_LL, 'nmin': FOF_NMIN, 'backend': backend,
          'setting': setting, 'gates_rank0': f0['gates'],
          'one_rank': fof_ref,
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            run=c['run'], branch=c['branch'],
                            merge_rounds=c['merge_rounds'],
                            sweeps=c['sweeps'], links=c['links'],
                            seconds=c['seconds'],
                            rank_pass_bit_identical=c[
                                'rank_pass_bit_identical'])
                       for rec, c in zip(recs, fofs)],
          'kernels_rank0': dict(f0['kernels'], rank=f0['rank'])})
    emit({'phase': 'dist_particles', 'ranks': nproc, 'box': PB_BOX,
          'counts': DPC_COUNTS, 'backend': backend, 'setting': setting,
          'wnpairs_max_rel_diff_vs_one_rank': worst, 'rtol': DPC_RTOL,
          'npairs_identical': True,
          'branches': dict({c: p0['counts'][c]['branch'] for c in DPC_COUNTS},
                           kddensity=p0['kddensity_branch']),
          'density_identical': p0['density_identical'],
          'sorted_identical': p0['sorted_identical'],
          'one_rank': pt_ref['run'],
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            run=c['run'], seconds=c['seconds'],
                            rank_pass_bit_identical=c[
                                'rank_pass_bit_identical'])
                       for rec, c in zip(recs, pts)],
          'kernels_rank0': dict(p0['kernels'], rank=p0['rank'])})
    pair0 = p0['kernels']['pairs'][0]
    kernels = dict(fof_rank=f0['rank'], pt_rank=p0['rank'],
                   fof_sweep=f0['kernels']['fof_sweep'],
                   fof_link_count=f0['kernels']['fof_link_count'],
                   fof_link_fill=f0['kernels']['fof_link_fill'],
                   kdd_link_count=p0['kernels']['kddensity'],
                   paircount={k: pair0[k] for k in (
                       'ms', 'bound_ms', 'bound_by', 'share_of_bound',
                       'shape', 'n1', 'n2', 'visited')})
    return launches, kernels


def dist_halo_catalog(pt_dir, comm=None):
    """dist_groups' halos: the DGR_NHALO seeded halo columns the parent
    saved in ``pt_dir`` as a HaloCatalog (Planck15, DGR_REDSHIFT) with
    its own Concentration column, on ``comm``'s ranks or on one rank."""
    from nbodykit_tpu_torch.cosmology import Planck15
    from nbodykit_tpu_torch.lab import ArrayCatalog, HaloCatalog
    cols = dict(np.load(os.path.join(pt_dir, 'halos.npz')))
    conc = cols.pop('Concentration')
    kw = dict(device='cuda') if comm is None else dict(comm=comm)
    halos = HaloCatalog(ArrayCatalog(cols, BoxSize=PB_BOX, **kw), Planck15,
                        DGR_REDSHIFT)
    halos['Concentration'] = conc
    return halos


def save_halo_columns(pt_dir):
    """DGR_NHALO halos in the boss_like box from DGR_HALO_SEED (numpy):
    uniform positions, Gaussian velocities of 300 km/s, Mass
    log-uniform in [10^12.5, 10^15] Msun/h and a Concentration in [3,
    12), saved in ``pt_dir``."""
    rs = np.random.RandomState(DGR_HALO_SEED)
    np.savez(os.path.join(pt_dir, 'halos.npz'),
             Position=rs.uniform(0, PB_BOX, (DGR_NHALO, 3)),
             Velocity=rs.normal(0, 300.0, (DGR_NHALO, 3)),
             Mass=10 ** rs.uniform(12.5, 15.0, DGR_NHALO),
             Concentration=rs.uniform(3.0, 12.0, DGR_NHALO))


DGR_PHASES = ('3pcf', 'cgm', 'fibercollisions', 'direct_bispectrum',
              'populate')
DGR_GALAXY_COLUMNS = ('Position', 'Velocity', 'gal_type', 'HaloMass')
DGR_CGM_COLUMNS = ('cgm_type', 'cgm_haloid', 'num_cgm_sats')
DGR_FIBER_COLUMNS = ('Label', 'Collided', 'NeighborID')


def dist_groups_steps(cat, dsky, imprinted, halos):
    """dist_groups' configurations through the user entry points, as
    (phase, closure) in DGR_PHASES order: the particles path's 3PCF, CGM
    and FiberCollisions, the bispectrum agreement's direct Bispectrum at
    BS_CHECK_NBINS and HaloCatalog.populate (Zheng07)."""
    from nbodykit_tpu_torch.lab import (Bispectrum, CylindricalGroups,
                                        FiberCollisions, SimulationBox3PCF,
                                        Zheng07Model)
    return (
        ('3pcf', lambda: SimulationBox3PCF(cat, PB_POLES, PB_3PT_EDGES)),
        ('cgm', lambda: CylindricalGroups(cat, rankby='Mass', rperp=2,
                                          rpar=10, flat_sky_los=[0, 0, 1])),
        ('fibercollisions', lambda: FiberCollisions(
            dsky['RA'], dsky['DEC'], seed=PB_SEED, comm=cat.comm)),
        ('direct_bispectrum', lambda: Bispectrum(
            imprinted, nbins=BS_CHECK_NBINS, method='direct')),
        ('populate', lambda: halos.populate(Zheng07Model,
                                            seed=DGR_HOD_SEED)))


def direct_modes(cat, comm=None):
    """The direct bispectrum's modes of ``cat`` (``pairblock_sum`` over
    the ranks of ``comm``), host complex, and sum |w|."""
    from nbodykit_tpu_torch.algorithms.bispectrum import shell_modes
    from nbodykit_tpu_torch.ops.pairblock import lattice_kvecs, pairblock_sum
    q, _ = shell_modes(BS_CHECK_NBINS)
    w = cat['Weight']
    total = w.abs().sum()
    if comm is not None:
        total = comm.all_reduce(total)
    modes = pairblock_sum(cat['Position'], w, lattice_kvecs(q, BS_BOX),
                          comm=comm)
    return modes.cpu().numpy(), float(total)


def slab_relabel(labels):
    """FOF labels renumbered by the slab branch's rule: groups by
    descending size, equal sizes by ascending least member (0 stays 0);
    host int64."""
    labels = np.asarray(labels).astype('i8')
    sizes = np.bincount(labels)
    n = len(labels)
    least = np.full(len(sizes), n, dtype='i8')
    np.minimum.at(least, labels, np.arange(n))
    groups = np.flatnonzero(sizes[1:]) + 1
    order = np.lexsort((least[groups], -sizes[groups]))
    relabel = np.zeros(len(sizes), dtype='i8')
    relabel[groups[order]] = np.arange(1, len(groups) + 1)
    return relabel[labels]


def dist_groups_reference(pt_dir):
    """The one-rank runs of dist_groups (the parent saved the boss_like
    catalogs and saves the halos here), each staged as a rank's: the
    zetas, the direct B, ntri and modes in the record; CGM's columns,
    FiberCollisions' slab-rule oracle (the one-rank partition relabelled
    by ``slab_relabel``, then the port's ``_assign_fibers`` on it) and
    the galaxies saved in ``pt_dir`` for rank 0's checks."""
    from nbodykit_tpu_torch.transform import SkyToUnitSphere
    save_halo_columns(pt_dir)
    cat, _, dsky = dist_particle_catalogs(pt_dir)
    imprinted = imprinted_catalog()
    halos = dist_halo_catalog(pt_dir)
    ref = dict(runs={}, n_rows=len(cat))
    for phase, step in dist_groups_steps(cat, dsky, imprinted, halos):
        res, ref['runs'][phase] = staged_run(step)
        if phase == '3pcf':
            ref['zeta'] = {'corr_%d' % ell: np.asarray(
                res.poles['corr_%d' % ell]) for ell in PB_POLES}
        elif phase == 'cgm':
            ref['cgm_rounds'] = res.rounds
            np.savez(os.path.join(pt_dir, 'cgm.npz'), **{
                c: res.groups[c].cpu().numpy() for c in DGR_CGM_COLUMNS})
        elif phase == 'fibercollisions':
            labels = res.labels['Label'].cpu().numpy()
            slab = slab_relabel(labels)
            pos = SkyToUnitSphere(dsky['RA'], dsky['DEC']).double()
            collided, neighbors = res._assign_fibers(pos.cpu().numpy(), slab,
                                                     PB_SEED)
            np.savez(os.path.join(pt_dir, 'fiber.npz'), Label=slab,
                     Collided=collided, NeighborID=neighbors)
            ref['fiber_groups'] = int(slab.max())
            ref['fiber_collided_one_rank'] = int(
                res.labels['Collided'].sum())
            ref['fiber_collided_slab_rule'] = int(collided.sum())
        elif phase == 'direct_bispectrum':
            ref['B'] = np.asarray(res.B['B'])
            ref['ntri'] = np.asarray(res.B['ntri'])
        else:
            ref['galaxies'] = len(res)
            np.savez(os.path.join(pt_dir, 'galaxies.npz'), **{
                c: res[c].cpu().numpy() for c in DGR_GALAXY_COLUMNS})
        del res
    ref['modes'], ref['sum_abs_w'] = direct_modes(imprinted)
    del cat, dsky, imprinted, halos
    torch.cuda.empty_cache()
    return ref


@contextlib.contextmanager
def captured_alm_calls():
    """The args of every ``threept_alm_cuda`` call inside, in order (the
    wrapper called through; its launches counted on the spy while it is
    installed and given back on exit)."""
    from nbodykit_tpu_torch.ops import threept_cuda as tc
    orig = tc.threept_alm_cuda
    calls = []

    def spy(*a):
        calls.append(a)
        return orig(*a)
    spy.launches = orig.launches
    tc.threept_alm_cuda = spy
    try:
        yield calls
    finally:
        tc.threept_alm_cuda = orig
        orig.launches = spy.launches


def alm_chunk_check(where, chunk):
    """The 3PCF moments kernel on one captured chunk (grid, w_s, p, live,
    ci, r2edges, ells) against its plain version on every query, within
    PB_RTOL of the largest moment; its time beside its bound (the
    particles path's counts: its candidates and in-bin pairs)."""
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    from nbodykit_tpu_torch.ops import threept_cuda as tc
    grid, w_s, p, live, ci, r2edges, ells = chunk
    a = tc.threept_alm_cuda(*chunk)
    b, plain_ms = timed(lambda: tc.threept_alm_plain(*chunk, block=128))
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    assert err <= PB_RTOL * scale, (where, 'threept_alm', err, scale)
    del a, b
    ms = cuda_ms(lambda: tc.threept_alm_cuda(*chunk), reps=3)
    nq, n2 = p.shape[0], grid.pos_s.shape[0]
    # the chunk's in-bin pairs: a cross count of its live queries
    w1 = w_s[:nq].contiguous() if w_s.shape[0] >= nq else \
        torch.ones(nq, dtype=torch.float64, device=p.device)
    hn, _ = pc.paircount_hist_cuda(grid, w_s, p, w1, live, ci, r2edges,
                                   '1d', is_auto=False)
    inbin = int(hn[1:-1].sum())
    cand = candidates(grid, ci, live)
    nlm = len(tc.lm_table(ells)[0])
    ops = cand * (pc.candidate_ops('1d', 2) - 1) + inbin * tc.ylm_ops(ells)
    mma = inbin * tc.ylm_mma_ops(ells)
    nbytes = tc.alm_bytes(nq, n2, grid.flat_s.element_size(),
                          grid.columns().numel(), len(r2edges) - 1, nlm)
    b_ms, b_by = bound(nbytes, ops, F64_UNFUSED_OPS,
                       more=[(mma, F64_TC_FLOPS)])
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / ms, max_abs_err=err,
                alm_max=scale, candidates=cand, inbin_pairs=inbin,
                at='%s: %d queries (%d live owner copies) of n=%d copies, '
                   '%d Y_lm, %d bins, %d candidates, %d in-bin pairs'
                   % (where, nq, int(live.sum()), n2, nlm,
                      len(r2edges) - 1, cand, inbin))


@contextlib.contextmanager
def captured_calls(module, names):
    """{name: [(args, kwargs)]}: every call of ``module``'s functions
    ``names`` inside, in order, each called through and put back on exit
    (dispatchers, which look their kernels up when called: the kernels
    count their launches as always)."""
    origs = {name: getattr(module, name) for name in names}
    calls = {name: [] for name in names}
    for name, orig in origs.items():
        def spy(*a, name=name, orig=orig, **kw):
            calls[name].append((a, kw))
            return orig(*a, **kw)
        setattr(module, name, spy)
    try:
        yield calls
    finally:
        for name, orig in origs.items():
            setattr(module, name, orig)


def captured_draws():
    """The HOD's draws inside: the calls of ``rng``'s threefry_fill and
    poisson_threefry dispatchers (:func:`captured_calls`)."""
    from nbodykit_tpu_torch import rng
    return captured_calls(rng, ('threefry_fill', 'poisson_threefry'))


def fof_links_checks(where, link_calls):
    """One FOF's link count and fill, replayed on their captured inputs
    (``link_kernel_checks``), and the first links sweep on the links
    they give (``links_sweep_check``), each against its plain version,
    bit for bit, timed beside its bound. Returns ({kernel: record},
    lines)."""
    names = [c[0] for c in link_calls]
    assert names == ['fof_link_count_cuda', 'fof_link_fill_cuda'], names
    a = link_calls[0][1]
    (recs, row, links, _), lines = _quiet(
        link_kernel_checks, where, a[:4], a[4], a[5:10], turns=False)
    recs['fof_sweep'] = links_sweep_check(where, row, links)
    return recs, lines


def draws_checks(where, calls):
    """The HOD's draws replayed: every threefry_fill call (key, counter,
    n, kind, bounds) and the Poisson draw of the satellite counts
    against their plain versions, bit for bit; the largest fill and the
    Poisson draw timed beside their bounds (the bytes of their inputs
    and outputs, the hashes this lam takes). Returns {kernel:
    record}."""
    from nbodykit_tpu_torch.ops import threefry_cuda as tf
    _, opcodes = sass_hash_ops()
    fills = calls['threefry_fill']
    for a, kw in fills:
        nd, ulp = _same(tf.threefry_fill_cuda(*a, **kw),
                        tf.threefry_fill_plain(*a, **kw))
        assert nd == 0, "%s: %s n=%d, %d differ (%d ulp)" % (
            where, a[3], a[2], nd, ulp)
    a, kw = max(fills, key=lambda c: c[0][2])
    n, kind = a[2], a[3]
    ms = cuda_ms(lambda: tf.threefry_fill_cuda(*a, **kw), reps=5)
    _, plain_ms = timed(lambda: tf.threefry_fill_plain(*a, **kw))
    b_ms, b_by = threefry_bound(n * tf.DTYPES[kind].itemsize, n, opcodes)
    recs = {'threefry_fill': dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=0, share_of_bound=b_ms / ms,
        at='%s: %s n=%d, the largest of %d draws (all bit for bit)'
           % (where, kind, n, len(fills)))}
    (pois,) = calls['poisson_threefry']
    key, lam = pois[0]
    sk, sp = {}, {}
    got = tf.poisson_threefry_cuda(key, lam, stats=sk)
    want, plain_ms = timed(lambda: tf.poisson_threefry_plain(key, lam,
                                                             stats=sp))
    nd = int((got != want).sum())
    assert nd == 0, "%s: %d Poisson counts differ" % (where, nd)
    assert sk['hashes'] == sp['hashes'], (sk, sp)
    del got, want
    ms = cuda_ms(lambda: tf.poisson_threefry_cuda(key, lam), reps=5)
    n = lam.numel()
    b_ms, b_by = threefry_bound(n * (lam.element_size() + 8), sk['hashes'],
                                opcodes)
    recs['poisson_threefry'] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=0, share_of_bound=b_ms / ms,
        at='%s: %s lam of %d halos -> int64 counts, %d hashes'
           % (where, str(lam.dtype)[6:], n, sk['hashes']))
    return recs


def dist_groups_rank(mesh, pt_dir):
    """One rank of ``dist_groups``: each configuration of
    ``dist_groups_steps`` once on this rank's rows, staged; the zetas, B,
    ntri, modes and CGM's rounds returned for the parent's checks; CGM's
    and FiberCollisions' columns and the galaxies gathered to rank 0 and
    held against the one-rank run bit for bit; the routes' rank passes
    at D = P (3PCF, CGM, FiberCollisions' FOF) against their plain
    versions; on rank 0, replayed on the inputs the run gave them and
    timed beside their bounds: the 3PCF's first moments chunk,
    FiberCollisions' link count, link fill and links sweep
    (``fof_links_checks``) and populate's draws (``draws_checks``)."""
    from nbodykit_tpu_torch.parallel.domain import slab_route
    from nbodykit_tpu_torch.transform import SkyToUnitSphere
    from nbodykit_tpu_torch.utils import GatherArray
    cat, _, dsky = dist_particle_catalogs(pt_dir, mesh)
    imprinted = imprinted_catalog(comm=mesh)
    halos = dist_halo_catalog(pt_dir, mesh)
    out = dict(runs={}, n_rows=len(cat), lines=[], kernels={})
    load = lambda name: np.load(os.path.join(pt_dir, name + '.npz'))  # noqa
    where = 'dist %%s rank 0 of %d' % mesh.size
    # the phases whose kernel inputs are captured in the run
    spies = {'3pcf': captured_alm_calls,
             'fibercollisions': captured_link_calls,
             'populate': captured_draws}
    alm_calls = []
    for phase, step in dist_groups_steps(cat, dsky, imprinted, halos):
        t1 = time.perf_counter()
        with spies.get(phase, contextlib.nullcontext)() as calls:
            res, rec = staged_run(step, mesh)
        out['runs'][phase] = rec
        launches = rec['launches']
        if phase == '3pcf':
            assert res.branch == 'slab', res.branch
            assert launches['threept_alm'] >= 1 and \
                launches['radix_rank'] >= 2, launches
            out['zeta'] = {'corr_%d' % ell: np.asarray(
                res.poles['corr_%d' % ell]) for ell in PB_POLES}
            alm_calls = calls
        elif phase == 'cgm':
            assert res.branch == 'slab' and launches['radix_rank'] >= 2, \
                (res.branch, launches)
            out['cgm_rounds'] = res.rounds
            cols = {c: GatherArray(res.groups[c], mesh, root=0)
                    for c in DGR_CGM_COLUMNS}
            if mesh.rank == 0:
                want = load('cgm')
                for c in DGR_CGM_COLUMNS:
                    assert np.array_equal(cols[c], want[c]), \
                        "dist_groups CGM: %s differs from one rank's" % c
                out['cgm_identical'] = True
        elif phase == 'fibercollisions':
            for name in ('fof_link_count', 'fof_link_fill', 'radix_rank'):
                assert launches[name] >= 1, launches
            cols = {c: GatherArray(res.labels[c], mesh, root=0)
                    for c in DGR_FIBER_COLUMNS}
            if mesh.rank == 0:
                want = load('fiber')
                for c in DGR_FIBER_COLUMNS:
                    assert np.array_equal(cols[c], want[c]), \
                        "dist_groups FiberCollisions: %s differs from " \
                        "the slab-rule oracle" % c
                out['fiber_identical'] = True
        elif phase == 'direct_bispectrum':
            out['B'] = np.asarray(res.B['B'])
            out['ntri'] = np.asarray(res.B['ntri'])
        else:
            assert res.comm is halos.comm
            assert launches['threefry_fill'] >= 1 and \
                launches['poisson_threefry'] >= 1, launches
            out['galaxies'] = res.csize
            cols = {c: GatherArray(res[c], mesh, root=0)
                    for c in DGR_GALAXY_COLUMNS}
            if mesh.rank == 0:
                want = load('galaxies')
                for c in DGR_GALAXY_COLUMNS:
                    assert np.array_equal(cols[c], want[c]), \
                        "dist_groups populate: %s differs" % c
                out['galaxies_identical'] = True
        rec['seconds'] = time.perf_counter() - t1
        del res
        if mesh.rank == 0 and phase == 'fibercollisions':
            recs, lines = fof_links_checks(where % phase, calls)
            out['kernels'].update(recs)
            out['lines'] += lines
        elif mesh.rank == 0 and phase == 'populate':
            out['kernels'].update(draws_checks(where % phase, calls))
        calls = None
        torch.cuda.empty_cache()
    out['modes'], _ = direct_modes(imprinted, mesh)
    # the routes' rank passes at D = P
    pos = cat['Position'].double()
    sphere = SkyToUnitSphere(dsky['RA'], dsky['DEC']).double() + 2.0
    chord = 2 * np.sin(0.5 * np.radians(62. / 60. / 60.))
    routes = (('3pcf', pos, PB_BOX, PB_3PT_EDGES[-1], 'both'),
              ('cgm', pos, PB_BOX, float(np.sqrt(2 ** 2 + 10 ** 2)), 'both'),
              ('fibercollisions', sphere, 4.0, chord, 'down'))
    for label, p, box, rmax, ghosts in routes:
        route, _, _ = slab_route(p, box, rmax, mesh, ghosts=ghosts,
                                 balance=True)
        same, rec0, lines = route_rank_check(mesh, route.dest)
        assert same
        out['lines'] += lines
        out['kernels']['rank_' + label] = rec0
        del route
    del cat, dsky, imprinted, halos, pos, sphere
    if mesh.rank == 0:
        out['kernels']['threept_alm'] = alm_chunk_check(where % '3pcf',
                                                        alm_calls[0])
    del alm_calls
    torch.cuda.empty_cache()
    return out


def dist_groups_phases(nproc, backend, recs, ref):
    """The parent's checks of dist_groups at ``nproc`` ranks against the
    one-rank runs, and its line. Returns ({'dist_groups_P<n>': launches
    summed over the ranks and phases}, rank 0's kernel records)."""
    grs = [rec['groups'] for rec in recs]
    for c in grs:
        for line in c.pop('lines'):
            emit(dict(line, dist_ranks=nproc))
    assert sum(c['n_rows'] for c in grs) == ref['n_rows']
    zeta_worst = 0.0
    for c in grs:
        for col, want in ref['zeta'].items():
            d = float(np.abs(c['zeta'][col] - want).max()
                      / np.abs(want).max())
            assert d <= DGR_ZETA_RTOL, ("dist_groups 3PCF", nproc, col, d)
            zeta_worst = max(zeta_worst, d)
        assert c['cgm_rounds'] == ref['cgm_rounds'], \
            (c['cgm_rounds'], ref['cgm_rounds'])
        assert c['galaxies'] == ref['galaxies']
    closed = ~np.isnan(ref['B'])
    b_worst, m_worst = 0.0, 0.0
    for c in grs:
        assert np.array_equal(np.nan_to_num(c['ntri'], nan=-1.0),
                              np.nan_to_num(ref['ntri'], nan=-1.0)), \
            "dist_groups direct B P=%d: ntri differs" % nproc
        d = float(np.abs(c['B'][closed] - ref['B'][closed]).max()
                  / np.abs(ref['B'][closed]).max())
        assert d <= DBS_B_RTOL, ("dist_groups direct B", nproc, d)
        b_worst = max(b_worst, d)
        dm = float(np.abs(c['modes'] - ref['modes']).max()
                   / ref['sum_abs_w'])
        assert dm <= DGR_MODES_RTOL, ("dist_groups modes", nproc, dm)
        m_worst = max(m_worst, dm)
    g0 = grs[0]
    assert g0['cgm_identical'] and g0['fiber_identical'] and \
        g0['galaxies_identical'], g0

    def summed(runs):
        return {k: sum(run['launches'][k] for run in runs)
                for k in runs[0]['launches']}
    launches = {'dist_groups_P%d' % nproc: summed(
        [r for c in grs for r in c['runs'].values()])}
    emit({'phase': 'dist_groups', 'ranks': nproc, 'box': PB_BOX,
          'phases': DGR_PHASES, 'backend': backend,
          'setting': DIST_SETTINGS[backend],
          'zeta_max_rel_diff_vs_one_rank': zeta_worst,
          'zeta_rtol': DGR_ZETA_RTOL, 'cgm_identical': True,
          'cgm_rounds': ref['cgm_rounds'],
          'fiber_identical_to_slab_rule_oracle': True,
          'fiber_groups': ref['fiber_groups'],
          'fiber_collided': dict(one_rank=ref['fiber_collided_one_rank'],
                                 slab_rule=ref['fiber_collided_slab_rule']),
          'direct_B_max_rel_diff_vs_one_rank': b_worst,
          'direct_B_rtol': DBS_B_RTOL, 'ntri_identical': True,
          'modes_max_diff_over_sum_abs_w': m_worst,
          'modes_rtol': DGR_MODES_RTOL, 'galaxies': ref['galaxies'],
          'galaxies_identical': True, 'one_rank': ref['runs'],
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            runs=c['runs']) for rec, c in zip(recs, grs)],
          'kernels_rank0': g0['kernels']})
    return launches, {'gr_' + k: v for k, v in g0['kernels'].items()}


def dist_task(seed):
    """One TaskManager task of dist_tasks: FFTPower (1d, CIC,
    compensated) of a seeded UniformCatalog at DTK_NMESH on the ambient
    mesh (the task's group)."""
    from nbodykit_tpu_torch.lab import FFTPower, UniformCatalog
    cat = UniformCatalog(nbar=DTK_NBAR, BoxSize=DTK_BOX, seed=seed)
    r = FFTPower(cat.to_mesh(Nmesh=DTK_NMESH, resampler='cic',
                             compensated=True), mode='1d')
    return dict(power=np.asarray(r.power['power'].real),
                modes=np.asarray(r.power['modes']), csize=cat.csize,
                ranks=1 if cat.comm is None else cat.comm.size)


def dist_tasks_reference():
    """The one-rank runs of dist_tasks' tasks, staged as a rank's."""
    res, rec = staged_run(lambda: [dist_task(s) for s in DTK_SEEDS])
    return dict(run=rec, power=res)


def dist_tasks_rank(mesh):
    """One rank of ``dist_tasks``: ``TaskManager(DTK_CPUS)`` over the
    world maps dist_task over DTK_SEEDS, once, staged; every rank
    returns every task's result. Replayed on the inputs that the run
    gave them, against their plain versions: the bucket rank of this
    rank's first exchange (its first task's paint, D = its group's
    ranks), bit for bit; on rank 0 that task's deposit, each timed
    beside its bound."""
    from nbodykit_tpu_torch.batch import TaskManager
    from nbodykit_tpu_torch.ops import paint, radix_cuda
    from nbodykit_tpu_torch.parallel.runtime import CurrentMesh
    with TaskManager(DTK_CPUS, comm=mesh) as tm, \
            captured_calls(radix_cuda, ('pass_rank_hist',)) as ranks, \
            captured_calls(paint, ('deposit_blocks',)) as deposits:
        group = CurrentMesh.get()
        res, rec = staged_run(lambda: tm.map(dist_task, DTK_SEEDS), mesh)
    for name, want in (('paint_deposit', 1), ('radix_rank', 2)):
        assert rec['launches'][name] >= want, rec['launches']
    out = dict(run=rec, power=res, lines=[], kernels={})
    (digit, D), _ = ranks['pass_rank_hist'][0]
    assert D == group.size == DTK_CPUS, (D, group.size)
    _, out['kernels']['rank'], out['lines'] = route_rank_check(
        group, digit, times=mesh.rank == 0)
    if mesh.rank == 0:
        payload, kw = deposits['deposit_blocks'][0]
        geom = dict(kw)
        ck = geom.pop('ck')
        label = 'dist_tasks: %s, the first task\'s deposit, rank 0 of ' \
            'the group of %d' % (geom['resampler'], group.size)
        (err, _), lines = _quiet(payload_deposit_check, label, payload,
                                 geom, ck)
        out['lines'] += lines
        out['kernels']['deposit'] = time_deposit(
            payload, geom, dict(ck=ck, rb=geom['rb'], cb=geom['cb']), err)
    return out


def dist_tasks_phase(nproc, backend, recs, ref):
    """The parent's checks of dist_tasks: every rank's results, in task
    order, each task's modes identical to its one-rank run's and P(k)
    within DIST_PK_RTOL; its line. Returns ({'dist_tasks_P<n>':
    launches summed over the ranks}, rank 0's kernel records)."""
    tks = [rec['tasks'] for rec in recs]
    for c in tks:
        for line in c.pop('lines'):
            emit(dict(line, dist_ranks=nproc))
    worst = 0.0
    for c in tks:
        assert len(c['power']) == len(DTK_SEEDS)
        for got, want in zip(c['power'], ref['power']):
            assert got['ranks'] == DTK_CPUS and got['csize'] == want['csize']
            assert np.array_equal(got['modes'], want['modes'])
            worst = max(worst, _pk_close(
                {k: got[k] for k in ('power', 'modes')},
                {k: want[k] for k in ('power', 'modes')},
                'dist_tasks P=%d task %d' % (nproc, got['csize'])))
    launches = {'dist_tasks_P%d' % nproc: {
        k: sum(c['run']['launches'][k] for c in tks)
        for k in tks[0]['run']['launches']}}
    emit({'phase': 'dist_tasks', 'ranks': nproc, 'cpus_per_task': DTK_CPUS,
          'tasks': len(DTK_SEEDS), 'nmesh': DTK_NMESH, 'backend': backend,
          'setting': DIST_SETTINGS[backend],
          'pk_max_rel_diff_vs_one_rank': worst, 'modes_identical': True,
          'one_rank': ref['run'],
          'per_rank': [dict(rank=rec['rank'], run=c['run'],
                            seconds=c['seconds'])
                       for rec, c in zip(recs, tks)],
          'kernels_rank0': tks[0]['kernels']})
    return launches, {'tk_' + k: v for k, v in tks[0]['kernels'].items()}


def run_ranks(target, nproc, args, timeout_s=600):
    """Spawn ``nproc`` processes of ``target(rank, nproc, *args, q)`` (the
    ``spawn`` start method) and return their records in rank order. A
    rank that dies fails the call; every process is stopped before it
    returns."""
    import queue as queue_mod
    ctx = torch.multiprocessing.get_context('spawn')
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, nproc) + tuple(args) + (q,))
             for r in range(nproc)]
    try:
        for p in procs:
            p.start()
        recs = {}
        deadline = time.monotonic() + timeout_s
        while len(recs) < nproc:
            dead = [p.exitcode for p in procs
                    if p.exitcode not in (None, 0)]
            assert not dead, "a rank exited with code %s" % dead
            assert time.monotonic() < deadline, \
                "ranks did not finish in %d s" % timeout_s
            try:
                rec = q.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            recs[rec['rank']] = rec
        for p in procs:
            p.join(timeout=60)
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        return [recs[r] for r in range(nproc)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


def _pk_close(got, want, what, rtol=DIST_PK_RTOL):
    """Every column of ``got`` within ``rtol`` of ``want``'s largest;
    ``modes`` identical. Returns the largest relative difference."""
    np.testing.assert_array_equal(got['modes'], want['modes'])
    worst = 0.0
    for col, w in want.items():
        if col == 'modes':
            continue
        w = np.asarray(w)
        scale = float(np.nanmax(np.abs(w)))
        d = float(np.nanmax(np.abs(np.asarray(got[col]) - w))) / scale
        assert d <= rtol, "%s %s: %g > %g" % (what, col, d, rtol)
        worst = max(worst, d)
    return worst


def dist_convpower_reference():
    """The one-rank run of dist_convpower's configuration, staged as a
    rank's: its poles, scalars, box, gates and records."""
    mesh, data_rec = staged_run(lambda: convpower_data(DCP_NMESH))
    r, alg_rec = staged_run(lambda: convpower_algorithm(mesh))
    ref = dict(data=data_rec, algorithm=alg_rec,
               gates=convpower_gates(r, mesh, DCP_NMESH),
               poles={c: np.asarray(r.poles[c]) for c in r.poles.variables},
               attrs={k: r.attrs[k] for k in DCP_SCALARS},
               box=mesh.attrs['BoxSize'].tolist(),
               box_center=mesh.attrs['BoxCenter'].tolist())
    del mesh, r
    torch.cuda.empty_cache()
    return ref


def dist_recon_reference(pos_path, ref_path):
    """The one-rank run of dist_recon's configuration: the FOF path's
    lognormal catalog (its positions saved at ``pos_path``, and its
    velocities beside them for dist_fof, for the ranks, which have no
    multi-rank lognormal draw) and ~1e8 uniform
    randoms, staged as a rank's; the field saved at ``ref_path``."""
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    cat = lognormal_catalog()
    np.save(pos_path, cat['Position'].cpu().numpy())
    np.save(pos_path.replace('.npy', '_velocity.npy'),
            cat['Velocity'].cpu().numpy())
    randoms = UniformCatalog(nbar=10 * LN_N / LN_BOX ** 3, BoxSize=LN_BOX,
                             seed=84)
    randoms['Position']
    (recon, field, p), rec = staged_run(lambda: fftrecon_run(cat, randoms))
    np.save(ref_path, field.value.cpu().numpy())
    ref = dict(run=rec, n_rows=(len(cat), len(randoms)),
               power={c: np.asarray(p.power[c]) for c in p.power.variables},
               field_mean=float(field.value.double().mean()))
    del cat, randoms, recon, field, p
    torch.cuda.empty_cache()
    return ref


def dist_survey_phases(nproc, backend, recs, cp_ref, rc_ref):
    """The parent's checks of dist_convpower (at DCP_RANKS) and
    dist_recon at ``nproc`` ranks against the one-rank runs, and their
    lines. Returns ({'dist_convpower_P<n>': launches, 'dist_recon_P<n>':
    ...} summed over the ranks, rank 0's kernel records)."""
    cps = [rec['convpower'] for rec in recs if 'convpower' in rec]
    assert len(cps) == (nproc if nproc in DCP_RANKS else 0), len(cps)
    rcs = [rec['recon'] for rec in recs]
    for c in cps + rcs:
        for line in c.pop('lines'):
            emit(dict(line, dist_ranks=nproc))
    rc_worst = max(_pk_close(c['power'], rc_ref['power'],
                             'dist_recon P=%d' % nproc) for c in rcs)
    r0 = rcs[0]
    assert r0['field_max_abs_diff'] <= DRC_FIELD_RTOL * r0['field_max'], r0
    assert all(abs(c['field_mean']) <= 1e-4 for c in rcs)
    assert sum(c['n_rows'][1] for c in rcs) == rc_ref['n_rows'][1]

    def summed(runs):
        return {k: sum(run['launches'][k] for run in runs)
                for k in runs[0]['launches']}
    launches = {'dist_recon_P%d' % nproc: summed([c['run'] for c in rcs])}
    setting = DIST_SETTINGS[backend]
    kernels = dict(rc_deposit=r0['kernels'])
    if cps:
        launches['dist_convpower_P%d' % nproc] = summed(
            [c['data'] for c in cps] + [c['algorithm'] for c in cps])
        kernels.update(dist_convpower_checks(nproc, backend, recs, cps,
                                             cp_ref))
    emit({'phase': 'dist_recon', 'ranks': nproc, 'nmesh': RC_NMESH,
          'backend': backend, 'setting': setting,
          'pk_max_rel_diff_vs_one_rank': rc_worst, 'pk_rtol': DIST_PK_RTOL,
          'field_max_abs_diff_vs_one_rank': r0['field_max_abs_diff'],
          'field_max': r0['field_max'], 'field_rtol': DRC_FIELD_RTOL,
          'one_rank': rc_ref['run'],
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            run=c['run'], field_mean=c['field_mean'],
                            seconds=c['seconds'])
                       for rec, c in zip(recs, rcs)],
          'kernels_rank0': r0['kernels']})
    return launches, kernels


def dist_convpower_checks(nproc, backend, recs, cps, cp_ref):
    """The parent's checks of dist_convpower's ranks ``cps`` against the
    one-rank run, and its line. Returns rank 0's kernel records."""
    cp_worst = max(_pk_close(c['poles'], cp_ref['poles'],
                             'dist_convpower P=%d' % nproc, DCP_PK_RTOL)
                   for c in cps)
    scalar_worst = 0.0
    for c in cps:
        assert c['box'] == cp_ref['box'], (c['box'], cp_ref['box'])
        assert c['box_center'] == cp_ref['box_center']
        for key in DCP_SCALARS:
            d = abs(c['attrs'][key] / cp_ref['attrs'][key] - 1)
            assert d <= DCP_SCALAR_RTOL, (key, d)
            scalar_worst = max(scalar_worst, d)
    assert sum(c['n_rows']['randoms'] for c in cps) == \
        cp_ref['gates']['N_randoms']
    emit({'phase': 'dist_convpower', 'ranks': nproc, 'nmesh': DCP_NMESH,
          'backend': backend, 'setting': DIST_SETTINGS[backend],
          'poles_max_rel_diff_vs_one_rank': cp_worst,
          'poles_rtol': DCP_PK_RTOL,
          'scalars_max_rel_diff_vs_one_rank': scalar_worst,
          'scalars_rtol': DCP_SCALAR_RTOL, 'gates_rank0': cps[0]['gates'],
          'one_rank': {k: cp_ref[k] for k in ('data', 'algorithm')},
          'per_rank': [dict(rank=rec['rank'], n_rows=c['n_rows'],
                            data=c['data'], algorithm=c['algorithm'],
                            rank_pass_bit_identical=c[
                                'rank_pass_bit_identical'],
                            seconds=c['seconds'])
                       for rec, c in zip(recs, cps)],
          'kernels_rank0': cps[0]['kernels']})
    return dict(cp_rank=cps[0]['kernels']['rank'],
                cp_deposit={k: v for k, v in cps[0]['kernels'].items()
                            if k != 'rank'})


# what each backend's dist_main line says of its setting
DIST_SETTINGS = {
    'gloo': ('P ranks sharing one card (cuda:0) over gloo, every '
             'collective staged through the host; not multi-card scaling'),
    'nccl': 'one rank a card (rank r on cuda:r) over NCCL',
}


def dist_main(run, nmesh, backend='gloo'):
    """The main path across P = 2 and 4 ranks sharing card 0 over gloo
    (or, with ``backend='nccl'``, one rank a card):
    each world's FFTPower held against the one-rank result of the same
    catalog (``run``, the main path's closure): identical modes, P(k,
    mu) and the poles within DIST_PK_RTOL, the gathered painted field
    within main_path's 1e-5 of its largest value, the mean of 1 + delta;
    every rank's rank pass bit for bit and rank 0's deposit within its
    tolerance. The same worlds run dist_convpower, dist_recon,
    dist_bispectrum, dist_forward, dist_fof, dist_particles, dist_groups
    and (at DTK_RANKS) dist_tasks against one-rank runs made here
    first. Returns {'dist_main_P<n>': {kernel: launches summed over the
    ranks}, 'dist_convpower_P<n>': ..., ...} and the kernels' records at
    each P."""
    import tempfile
    t0 = time.perf_counter()
    mesh, r1 = run()
    ref_field = mesh.to_real_field().value
    ref = {'power': {c: np.asarray(r1.power[c]) for c in r1.power.variables},
           'poles': {c: np.asarray(r1.poles[c]) for c in r1.poles.variables}}
    del mesh, r1
    launches, kernel_recs = {}, {}
    workroot = tempfile.mkdtemp(prefix='nbk-dist-main-')
    try:
        ref_path = os.path.join(workroot, 'field.npy')
        np.save(ref_path, ref_field.cpu().numpy())
        del ref_field
        torch.cuda.empty_cache()
        # the one-rank runs of dist_convpower and dist_recon
        t_ref = time.perf_counter()
        cp_ref = dist_convpower_reference()
        rc_pos_path = os.path.join(workroot, 'recon_positions.npy')
        rc_ref_path = os.path.join(workroot, 'recon_field.npy')
        rc_ref = dist_recon_reference(rc_pos_path, rc_ref_path)
        bs_ref = dist_bispectrum_reference()
        fw_dir = os.path.join(workroot, 'forward')
        os.makedirs(fw_dir)
        fw_ref = dist_forward_reference(fw_dir)
        pt_dir = os.path.join(workroot, 'particles')
        os.makedirs(pt_dir)
        fof_ref = dist_fof_reference(rc_pos_path, pt_dir)
        pt_ref = dist_particles_reference(pt_dir)
        gr_ref = dist_groups_reference(pt_dir)
        tk_ref = dist_tasks_reference()
        emit({'phase': 'dist_one_rank_references',
              'seconds': time.perf_counter() - t_ref})
        for nproc in DIST_RANKS:
            workdir = os.path.join(workroot, 'P%d' % nproc)
            os.makedirs(workdir)
            tw = time.perf_counter()
            recs = run_ranks(dist_rank, nproc,
                             (workdir, ref_path, nmesh, backend,
                              rc_pos_path, rc_ref_path, fw_dir, pt_dir))
            world_s = time.perf_counter() - tw
            for rec in recs:
                for line in rec.pop('lines'):
                    emit(dict(line, dist_ranks=nproc))
            worst = max(max(_pk_close(rec[s], ref[s], 'P=%d rank %d %s'
                                      % (nproc, rec['rank'], s))
                            for s in ('power', 'poles')) for rec in recs)
            r0 = recs[0]
            assert r0['field_max_abs_diff'] <= 1e-5 * r0['field_max'], r0
            assert all(abs(rec['field_mean'] - 1) < 1e-5 for rec in recs)
            assert sum(rec['n_rows'] for rec in recs) == recs[0]['csize']
            counts = {k: sum(rec['launches'][k] + rec['cat_launches'][k]
                             for rec in recs)
                      for k in recs[0]['launches']}
            launches['dist_main_P%d' % nproc] = counts
            kernel_recs[nproc] = dict(rank=r0['rank_timing'],
                                      deposit=r0['deposit_timing'])
            emit({'phase': 'dist_main', 'ranks': nproc, 'nmesh': nmesh,
                  'backend': backend, 'setting': DIST_SETTINGS[backend],
                  'world_s': world_s,
                  'pk_max_rel_diff_vs_one_rank': worst,
                  'field_max_abs_diff_vs_one_rank':
                      r0['field_max_abs_diff'],
                  'field_max': r0['field_max'],
                  'per_rank': [{k: rec[k] for k in (
                      'rank', 'n_rows', 'wall_s', 'run_ms', 'stages_ms',
                      'peak_bytes', 'launches', 'field_mean',
                      'rank_pass_bit_identical', 'main_seconds',
                      'rank_seconds')}
                      for rec in recs],
                  'rank_pass_D_eq_P': r0['rank_timing'],
                  'deposit_extended_slab': r0['deposit_timing']})
            survey_launches, survey_kernels = dist_survey_phases(
                nproc, backend, recs, cp_ref, rc_ref)
            launches.update(survey_launches)
            kernel_recs[nproc].update(survey_kernels)
            slice_launches, slice_kernels = dist_slice_phases(
                nproc, backend, recs, bs_ref, fw_ref)
            launches.update(slice_launches)
            kernel_recs[nproc].update(slice_kernels)
            pt_launches, pt_kernels = dist_particle_phases(
                nproc, backend, recs, fof_ref, pt_ref)
            launches.update(pt_launches)
            kernel_recs[nproc].update(pt_kernels)
            gr_launches, gr_kernels = dist_groups_phases(nproc, backend,
                                                         recs, gr_ref)
            launches.update(gr_launches)
            kernel_recs[nproc].update(gr_kernels)
            if nproc in DTK_RANKS:
                tk_launches, tk_kernels = dist_tasks_phase(
                    nproc, backend, recs, tk_ref)
                launches.update(tk_launches)
                kernel_recs[nproc].update(tk_kernels)
    finally:
        shutil.rmtree(workroot, ignore_errors=True)
    emit({'phase': 'dist_main_total', 'seconds': time.perf_counter() - t0})
    return launches, kernel_recs


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


def link_turns(name, grid_args, a, out, geo, reps=10):
    """The link kernel ``name`` as built, its first design and its tile
    design (csrc/variants/fof_links_first_design.cu, fof_links_tiles.cu)
    launched alone in turns (first, tiles, kernel, kernel, tiles, first)
    into ``out``, which holds the kernel's result on entry; before each
    turn ``out`` is set to -1 (no count or slot), and every turn must
    leave it bit for bit. Returns {who: ms}, the means of the turns of
    'kernel', 'first' and 'tiles'."""
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    ref = out.clone()
    call = fc.grid_launch_args(*grid_args, a, out, *geo)
    fns = {'kernel': fc._fn(name)}
    for who, lib in (('first', 'fof_links_first_design'),
                     ('tiles', 'fof_links_tiles')):
        fns[who] = getattr(first_designs()[lib], name)
        fns[who].argtypes = fc.grid_argtypes(name)
    t = {who: [] for who in fns}
    for who in ('first', 'tiles', 'kernel', 'kernel', 'tiles', 'first'):
        out.fill_(-1)
        t[who].append(launch_ms(fns[who], call, reps=reps))
        assert torch.equal(out, ref), (name, who)
    return {who: float(np.mean(v)) for who, v in t.items()}


def link_kernel_checks(where, args, cols, geo, fill=True, turns=True):
    """The link count (and fill) on one grid's sorted arrays ``args``
    (pos, ci, flat, valid): each kernel against its plain version on
    every query, bit for bit; with ``turns``, its earlier designs
    launched in turns with it (``link_turns``), bit for bit; the
    wrapper's time (CUDA events, 20
    calls), the plain version's (one call) and the byte bound
    (``fof_cuda.link_count_bytes`` / ``link_fill_bytes``, the column-table
    entries that the searching queries reach counted on the card).
    Returns ({kernel: record}, row, links or None, E)."""
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    pos_s, ci_s, flat_s, valid_s = args
    n = pos_s.shape[0]
    pb, kb = pos_s.element_size(), flat_s.element_size()
    offsets, ncell, _, _, periodic = geo

    def entries(searching):
        return fc.link_table_entries(ci_s, searching, ncell, offsets,
                                     periodic)
    counts = fc.fof_link_count_cuda(*args, cols, *geo)
    pc, count_plain_ms = timed(lambda: fc.fof_link_count_plain(*args, *geo))
    nd = int((counts != pc).sum())
    assert nd == 0, "%s: %d link counts differ" % (where, nd)
    del pc
    row = torch.zeros(n + 1, dtype=torch.int64, device='cuda')
    torch.cumsum(counts, 0, out=row[1:])
    E = int(row[-1])
    cases = [('fof_link_count', None, counts, count_plain_ms,
              fc.link_count_bytes(n, pb, kb, entries(valid_s)),
              lambda: fc.fof_link_count_cuda(*args, cols, *geo))]
    links = None
    if fill:
        links = fc.fof_link_fill_cuda(*args, cols, row, *geo, nlinks=E)
        pl, fill_plain_ms = timed(lambda: fc.fof_link_fill_plain(
            *args, row, *geo))
        assert torch.equal(links, pl), "%s: the link lists differ" % where
        del pl
        cases.append(('fof_link_fill', row, links, fill_plain_ms,
                      fc.link_fill_bytes(
                          n, E, pb, kb,
                          entries(valid_s & (row[1:] > row[:-1]))),
                      lambda: fc.fof_link_fill_cuda(*args, cols, row, *geo,
                                                    nlinks=E)))
    recs = {}
    for name, a, ref, plain_ms, nbytes, wrapper in cases:
        ms = cuda_ms(wrapper, reps=20)
        b_ms, b_by = bound(nbytes, 0, F32_FLOPS)
        recs[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, max_abs_err=0,
            share_of_bound=b_ms / ms,
            at='%s f%d int%d keys n=%d, %s cells, E=%d' % (
                where, 8 * pb, 8 * kb, n,
                'x'.join(str(int(c)) for c in ncell), E))
        if turns:
            t = link_turns('nbk_' + name, (*args, cols), a, ref.clone(), geo)
            kernel_ms, first_ms = t['kernel'], t['first']
            recs[name].update(
                kernel_ms=kernel_ms, first_design_ms=first_ms,
                tiles_ms=t['tiles'], kernel_share_of_bound=b_ms / kernel_ms,
                first_design_share_of_bound=b_ms / first_ms,
                first_design_over_kernel=first_ms / kernel_ms,
                tiles_over_kernel=t['tiles'] / kernel_ms)
    emit({'phase': 'fof_link_kernels', 'case': where, **recs})
    return recs, row, links, E


def link_key_width_checks():
    """The link kernels' other instantiations: f32 and f64 positions on a
    grid of 2^31 cells (2048 x 1024 x 1024 at ll 1: int64 ids) and f64
    on the same positions at ll 2 (int32 ids), 2e5 points, half in 2,000
    Gaussian blobs of 0.6 ll, periodic (``link_kernel_checks``).
    Returns {case: {kernel: ms, kernel_ms, first_design_ms, tiles_ms,
    bound_ms}}."""
    from nbodykit_tpu_torch.ops.devicehash import DeviceGridHash
    rng = np.random.RandomState(8)
    box = np.array([2048.0, 1024.0, 1024.0])
    half = 10 ** 5
    centres = rng.uniform(0, 1, (2000, 3)) * box
    pos = np.mod(np.concatenate([
        centres[rng.randint(2000, size=half)]
        + rng.normal(scale=0.6, size=(half, 3)),
        rng.uniform(0, 1, (half, 3)) * box]), box)
    out = {}
    for label, dt, ll in (('int64_f32', 'f4', 1.0), ('int64_f64', 'f8', 1.0),
                          ('int32_f64', 'f8', 2.0)):
        p = torch.as_tensor(pos.astype(dt), device='cuda')
        grid = DeviceGridHash(p, box, ll)
        assert (grid.flat_s.element_size() == 8) == label.startswith('int64')
        ci_s = grid.cell_of(grid.pos_s).contiguous()
        recs, *_ = link_kernel_checks(
            'keys_' + label, (grid.pos_s, ci_s, grid.flat_s, grid.valid_s),
            grid.columns(), grid.geometry(ll ** 2))
        keep = ('ms', 'kernel_ms', 'first_design_ms', 'tiles_ms',
                'bound_ms')
        out[label] = {k: {kk: v[kk] for kk in keep}
                      for k, v in recs.items()}
    return out


def fof_mode_checks(label, pos, box, ll):
    """Both sweep modes on one catalog's grid: the link count and fill
    kernels against their plain versions; each mode's fixpoint (the
    search sweep kernel, or the links sweep kernel over the list, to no
    change) giving the labels and sweeps of ``fof_fixpoint`` (which must
    take the links mode) and the roots of an argsort-ordered run; the
    search and links sweep kernels against ``fof_sweep_plain`` at the
    first sweep and at the fixpoint, all bit for bit; the link kernels
    also against their first design (``link_kernel_checks``). Times:
    each kernel (CUDA events), its plain version (one call), each mode's
    fixpoint
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

    # the link kernels against the plain link list and their first design
    link_recs, row, links, E = link_kernel_checks(label, args, cols, geo)

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
        'fof_link_count': dict(link_recs['fof_link_count'], at=where),
        'fof_link_fill': dict(link_recs['fof_link_fill'], at=where),
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
    key_widths = link_key_width_checks()
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
                               ['fof_link_count'],
                               at_key_widths={k: v['fof_link_count']
                                              for k, v in key_widths.items()}),
        'fof_link_fill': dict(flow['fof_link_fill'],
                              at_clustered_2e6=at_clustered['fof_link_fill'],
                              at_key_widths={k: v['fof_link_fill']
                                             for k, v in key_widths.items()}),
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


# ---------------------------------------------------------------------------
# the io path: bigfile save and reload (nbodykit_tpu_torch/io)
# ---------------------------------------------------------------------------

# the convpower path's randoms: 10 nbar at the same box, seed 84
IO_RANDOMS_SEED = 84
# timed repetitions of each save and load (cut from 2 for the script's
# time, PERF.md section 4)
IO_REPS = 1
# per-bin |P| agreement of two runs that differ only in the order of the
# deposit's f32 atomic adds
IO_POWER_RTOL = 1e-5


def fs_type(path):
    """(mount point, filesystem type) of ``path``, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ('', '?')
    with open('/proc/mounts') as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace('\\040', ' ')
            if (path == mnt or path.startswith(mnt.rstrip('/') + '/')) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, parts[2])
    return best


def need_disk(path, nbytes):
    """Raise unless the filesystem of ``path`` has ``nbytes`` and a 10%
    (at least 256 MB) margin free."""
    want = int(nbytes * 1.1) + (256 << 20)
    free = shutil.disk_usage(path).free
    if free < want:
        raise RuntimeError("io phase: %s has %d bytes free, the write needs "
                           "%d (%d of data and the margin)"
                           % (path, free, want, nbytes))


def drop_page_cache(path):
    """Flush every file under ``path`` to disk and ask the kernel to drop
    its cached pages (``fsync``, ``POSIX_FADV_DONTNEED``): the next read
    comes from the device unless the filesystem lives in memory
    (tmpfs)."""
    for root, _, names in os.walk(path):
        for n in names:
            fd = os.open(os.path.join(root, n), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


class HostPeak(object):
    """The peak resident set of this process inside a ``with`` block,
    sampled from /proc/self/statm every millisecond by a thread."""

    def __enter__(self):
        import threading
        self.page = os.sysconf('SC_PAGE_SIZE')
        self.peak = self.rss()
        self.start = self.peak
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def rss(self):
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self.rss())

    def __exit__(self, *args):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


def host_s(fn):
    """(result, host seconds) of ``fn``, the card drained before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_spread(fn, reps=IO_REPS, warmup=1, before=None):
    """(last result, {median, min, max, all} host seconds): ``warmup``
    untimed and ``reps`` timed calls of ``fn``, ``before()`` run untimed
    ahead of each."""
    out, ts = None, []
    for i in range(warmup + reps):
        if before is not None:
            before()
        out = None
        out, t = host_s(fn)
        if i >= warmup:
            ts.append(t)
    return out, {'median': float(np.median(ts)), 'min': min(ts),
                 'max': max(ts), 'all': ts}


def rate(nbytes, t):
    """GB/s of ``nbytes`` moved in the median of a host_spread record."""
    return nbytes / t['median'] / 1e9


def fresh_dir(path):
    if os.path.exists(path):
        shutil.rmtree(path)
    return path


def load_steps(path, block, verify=True):
    """The steps a BigFileCatalog or BigFileMesh takes to put a block on
    the card, one at a time: the checksum of every part file (none with
    ``verify=False``), the native threaded read, the host-to-device
    copy. Returns (tensor, {step: host seconds})."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.io.bigfile import BigFileDataset
    with set_options(io_verify_checksums=verify):
        ds = BigFileDataset(path, block)
        _, t_verify = host_s(lambda: ds._verify_files(0, ds.size))
        arr, t_read = host_s(lambda: ds.read(0, ds.size))
    dev, t_h2d = host_s(lambda: torch.as_tensor(arr).to('cuda'))
    return dev, {'checksum': t_verify, 'read': t_read, 'h2d': t_h2d,
                 'total': t_verify + t_read + t_h2d}


def load_spread(path, block, cold, verify=True):
    """(tensor, {step: {median, min, max}} host seconds, host peak bytes
    above the start): ``load_steps`` IO_REPS times, the page cache
    dropped before each when ``cold``, else after one warm-up. A cold
    load with ``verify`` reads each file twice, the checksum's read cold
    and the data's warm; ``verify=False`` times the cold data read."""
    steps, out, peak = [], None, 0
    for i in range(IO_REPS + (0 if cold else 1)):
        if cold:
            drop_page_cache(path)
        out = None
        torch.cuda.empty_cache()
        with HostPeak() as hp:
            out, t = load_steps(path, block, verify)
        peak = max(peak, hp.peak - hp.start)
        if cold or i >= 1:
            steps.append(t)
    rec = {k: {'median': float(np.median([s[k] for s in steps])),
               'min': min(s[k] for s in steps),
               'max': max(s[k] for s in steps)} for k in steps[0]}
    if verify:
        rec['checksum_share'] = rec['checksum']['median'] / \
            rec['total']['median']
    return out, rec, peak


def same_bits(a, b):
    """True when two tensors on one device hold the same bytes."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ia = a.contiguous().view(torch.uint8)
    ib = b.contiguous().view(torch.uint8)
    return bool(torch.equal(ia, ib))


def io_catalog(root, cat):
    """Part 1: the lognormal path's catalog (Position and Velocity, f4)
    saved and reloaded with BigFileCatalog, then the path's compensated
    CIC mesh and FFTPower on the reloaded catalog with every kernel's
    launches counted, against the same run on the catalog in memory."""
    from nbodykit_tpu_torch.lab import BigFileCatalog
    cols = ['Position', 'Velocity']
    nbytes = sum(cat[c].numel() * cat[c].element_size() for c in cols)
    d = os.path.join(root, 'lognormal')
    need_disk(root, nbytes)
    _, t_save = host_spread(lambda: cat.save(fresh_dir(d), columns=cols))
    _, t_load = host_spread(
        lambda: [BigFileCatalog(d)[c] for c in cols])
    mesh_mem, r_mem = lognormal_fftpower(cat)
    painted = mesh_mem.to_real_field()
    with counted_launches() as launches:
        torch.cuda.reset_peak_memory_stats()
        cat2 = BigFileCatalog(d)
        mesh2, r2 = lognormal_fftpower(cat2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    # the path's paint: deposit and rank pass; no draws, the catalog
    # came from the files
    assert launches['paint_deposit'] >= 1 and launches['radix_rank'] >= 1, \
        launches
    for k in ('threefry_fill', 'poisson_threefry', 'poisson_cells'):
        assert launches[k] == 0, launches
    for c in cols:
        assert cat2[c].device.type == 'cuda', cat2[c].device
        assert same_bits(cat2[c], cat[c]), "reloaded %s differs" % c
    field2 = mesh2.to_real_field()
    fdiff = float((field2.value - painted.value).abs().max())
    fmax = float(painted.value.abs().max())
    assert fdiff <= 1e-5 * fmax, (fdiff, fmax)
    del field2, mesh2
    m1, m2 = r_mem.power['modes'], r2.power['modes']
    assert np.array_equal(m1, m2), "mode counts differ"
    sel = m1 > 0
    p1, p2 = r_mem.power['power'].real[sel], r2.power['power'].real[sel]
    rel = np.abs(p2 - p1) / np.abs(p1)
    assert np.isfinite(p2).all() and rel.max() <= IO_POWER_RTOL, rel.max()
    emit({'phase': 'io_catalog', 'N': len(cat), 'columns': cols,
          'bytes': nbytes, 'save_s': t_save, 'save_gb_s': rate(nbytes, t_save),
          'load_s': t_load, 'load_gb_s': rate(nbytes, t_load),
          'reloaded_bit_identical': True,
          'field_max_abs_diff': fdiff, 'field_max': fmax,
          'power_bins': int(sel.sum()), 'power_max_rel_diff': float(rel.max()),
          'power_rtol': IO_POWER_RTOL, 'modes_equal': True,
          'peak_gb_reload_algorithm': peak / 1e9, 'launches': launches})
    shutil.rmtree(d)
    return painted, launches



def io_randoms(root):
    """Part 2: the convpower path's 99,976,127 uniform randoms (Position,
    f8, 2.4 GB, 3 part files): the write, a cold and a warm read by the
    threaded native reader, the host-to-device copy."""
    from nbodykit_tpu_torch.io import _native
    from nbodykit_tpu_torch.lab import BigFileCatalog, UniformCatalog
    from nbodykit_tpu_torch.utils import as_numpy
    nbar = 10 * CP_N / CP_BOX ** 3
    randoms = UniformCatalog(nbar=nbar, BoxSize=CP_BOX, seed=IO_RANDOMS_SEED)
    pos = randoms['Position']
    nbytes = pos.numel() * pos.element_size()
    d = os.path.join(root, 'randoms')
    need_disk(root, nbytes)
    _, t_d2h = host_spread(lambda: as_numpy(pos))
    host = as_numpy(pos)
    _, t_cks = host_spread(lambda: _native.checksum(host))
    del host
    with HostPeak() as hp:
        _, t_write = host_spread(
            lambda: randoms.save(fresh_dir(d), columns=['Position']))
    nfile = len([n for n in os.listdir(os.path.join(d, 'Position'))
                 if n not in ('header', 'attr-v2')])
    cold_dev, cold, cold_peak = load_spread(d, 'Position', cold=True)
    assert same_bits(cold_dev, pos), "cold reload differs"
    del cold_dev
    raw_dev, raw, _ = load_spread(d, 'Position', cold=True, verify=False)
    assert same_bits(raw_dev, pos), "cold unverified reload differs"
    del raw_dev
    warm_dev, warm, warm_peak = load_spread(d, 'Position', cold=False)
    assert same_bits(warm_dev, pos), "warm reload differs"
    del warm_dev
    # the user entry, whole
    got, t_entry = host_s(lambda: BigFileCatalog(d)['Position'])
    assert got.device.type == 'cuda' and same_bits(got, pos)
    del got
    emit({'phase': 'io_randoms', 'N': len(randoms), 'bytes': nbytes,
          'part_files': nfile, 'd2h_s': t_d2h,
          'd2h_gb_s': rate(nbytes, t_d2h), 'checksum_s': t_cks,
          'checksum_gb_s': rate(nbytes, t_cks),
          'write_s': t_write, 'write_gb_s': rate(nbytes, t_write),
          'write_host_peak_gb': (hp.peak - hp.start) / 1e9,
          'cold': cold, 'cold_total_gb_s': rate(nbytes, cold['total']),
          'cold_unverified': raw,
          'cold_read_gb_s': rate(nbytes, raw['read']),
          'warm': warm, 'warm_read_gb_s': rate(nbytes, warm['read']),
          'warm_total_gb_s': rate(nbytes, warm['total']),
          'h2d_gb_s': rate(nbytes, warm['h2d']),
          'host_peak_gb_load': max(cold_peak, warm_peak) / 1e9,
          'entry_load_s': t_entry, 'reloaded_bit_identical': True})
    shutil.rmtree(d)


def io_mesh(root, painted):
    """Part 3: part 1's painted 1024^3 f4 field saved with
    MeshSource.save (4.3 GB, 32 part files) and reloaded with
    BigFileMesh: bit for bit on the card, and FFTPower of the reloaded
    field against FFTPower of the field before saving. The cold data
    read alone is timed on part 2's files."""
    from nbodykit_tpu_torch.algorithms.fftpower import FFTPower
    from nbodykit_tpu_torch.base.mesh import FieldMesh
    from nbodykit_tpu_torch.lab import BigFileMesh
    fm = FieldMesh(painted)
    nbytes = painted.value.numel() * painted.value.element_size()
    d = os.path.join(root, 'mesh')
    need_disk(root, nbytes)
    with HostPeak() as hp:
        _, t_save = host_spread(lambda: fm.save(fresh_dir(d)))
    save_peak = hp.peak - hp.start
    nfile = len([n for n in os.listdir(os.path.join(d, 'Field'))
                 if n not in ('header', 'attr-v2')])
    torch.cuda.reset_peak_memory_stats()
    cold_dev, cold, cold_peak = load_spread(d, 'Field', cold=True)
    assert same_bits(cold_dev.reshape(painted.value.shape), painted.value)
    del cold_dev
    warm_dev, warm, warm_peak = load_spread(d, 'Field', cold=False)
    assert same_bits(warm_dev.reshape(painted.value.shape), painted.value)
    del warm_dev
    dev_peak = torch.cuda.max_memory_allocated()
    # the user entry: BigFileMesh and compute, then FFTPower of the
    # reloaded field
    field, t_entry = host_s(lambda: BigFileMesh(d).compute(mode='real'))
    assert field.value.device.type == 'cuda'
    assert same_bits(field.value, painted.value), "reloaded field differs"
    kw = dict(mode='2d', kmin=0.001, Nmu=10)
    r_saved = FFTPower(fm, **kw).power
    r_loaded = FFTPower(FieldMesh(field), **kw).power
    del field
    assert np.array_equal(r_saved['modes'], r_loaded['modes'])
    sel = r_saved['modes'] > 0
    p1, p2 = (r['power'].real[sel] for r in (r_saved, r_loaded))
    rel = float((np.abs(p2 - p1) / np.abs(p1)).max())
    assert rel <= 1e-12, rel
    emit({'phase': 'io_mesh', 'nmesh': LN_NMESH, 'bytes': nbytes,
          'part_files': nfile, 'save_s': t_save,
          'save_gb_s': rate(nbytes, t_save),
          'save_host_peak_gb': save_peak / 1e9,
          'cold': cold, 'cold_total_gb_s': rate(nbytes, cold['total']),
          'warm': warm, 'warm_total_gb_s': rate(nbytes, warm['total']),
          'warm_read_gb_s': rate(nbytes, warm['read']),
          'h2d_gb_s': rate(nbytes, warm['h2d']),
          'host_peak_gb_load': max(cold_peak, warm_peak) / 1e9,
          'device_peak_gb_load': dev_peak / 1e9, 'entry_load_s': t_entry,
          'reloaded_bit_identical': True,
          'fftpower_max_rel_diff': rel, 'fftpower_rtol': 1e-12})
    shutil.rmtree(d)


def io_path(cat):
    """The io path: the bigfile reader's g++ build, then the three parts
    in a temporary directory ($TMPDIR), removed at the end whatever
    happens (an error propagates). Returns part 1's launch counts."""
    import tempfile
    from nbodykit_tpu_torch import _build
    t0 = time.perf_counter()
    built = bool(_build.build_all(['bigfile_io']))
    build_s = time.perf_counter() - t0 if built else None
    _build.load_host('bigfile_io')
    root = tempfile.mkdtemp(prefix='nbk_io_')
    mnt, fstype = fs_type(root)
    emit({'phase': 'io_setup', 'library': 'bigfile_io', 'compiler': 'g++',
          'flags': _build.host_flags('bigfile_io'), 'built_here': built,
          'build_s': build_s, 'tmpdir': root, 'mount': mnt,
          'fstype': fstype, 'free_bytes': shutil.disk_usage(root).free,
          'cpu_count': os.cpu_count()})
    try:
        painted, launches = io_catalog(root, cat)
        torch.cuda.empty_cache()
        io_randoms(root)
        torch.cuda.empty_cache()
        io_mesh(root, painted)
        del painted
        torch.cuda.empty_cache()
    finally:
        if os.path.exists(root):
            shutil.rmtree(root)
    return launches


# the particles path: the reference's boss_like sample
# (benchmarks/conftest.py:24): 1e6 lognormal galaxies in a box of 2500
PB_BOX, PB_N, PB_NMESH, PB_BIAS, PB_SEED = 2500.0, 1e6, 1024, 2.0, 42
PB_RANDOMS_SEED, PB_WEIGHT_SEED, PB_RANK_SEED = 84, 7, 8
PB_EDGES = np.linspace(5, 150, 30)
PB_RP_EDGES, PB_PIMAX = np.logspace(0, 2, 21), 60
PB_3PT_EDGES, PB_POLES = np.linspace(20, 150, 14), [0, 1, 2, 3, 4]
PB_THETA = np.logspace(-1, 0.5, 11)                 # degrees
# queries of the strided checks of every pair count against the plain
# version (the 1d auto count and the 3PCF chunk are checked whole)
PB_CHECK_PAIRS = 20000
# the path's pair counts, in the order the flow launches them
PB_SHAPES = ('box_1d', 'box_2d', 'box_projected', 'box_cross_1d',
             'survey_DD', 'survey_DR', 'survey_RR', 'survey_angular')
PB_RTOL = 1e-12


def particles_catalogs():
    """The boss_like LogNormalCatalog with seeded Weight and Mass
    columns (numpy, uniform in [0.5, 1.5) and [0, 1)) and 1e6 uniform
    randoms."""
    from nbodykit_tpu_torch.source.catalog import (LogNormalCatalog,
                                                   UniformCatalog)
    cat = LogNormalCatalog(linear_power(), nbar=PB_N / PB_BOX ** 3,
                           BoxSize=PB_BOX, Nmesh=PB_NMESH, bias=PB_BIAS,
                           seed=PB_SEED)
    n = len(cat)
    cat['Weight'] = np.random.RandomState(PB_WEIGHT_SEED).uniform(0.5, 1.5, n)
    cat['Mass'] = np.random.RandomState(PB_RANK_SEED).uniform(0, 1, n)
    randoms = UniformCatalog(nbar=PB_N / PB_BOX ** 3, BoxSize=PB_BOX,
                             seed=PB_RANDOMS_SEED)
    return cat, randoms


def sky_catalog(cat):
    """The catalog on the sky (RA, DEC, Redshift; Weight kept), seen from
    the box centre with Planck15 distances."""
    from nbodykit_tpu_torch.cosmology import Planck15
    from nbodykit_tpu_torch.source.catalog.array import ArrayCatalog
    from nbodykit_tpu_torch.transform import CartesianToSky
    ra, dec, z = CartesianToSky(cat['Position'].double(), Planck15,
                                observer=[PB_BOX / 2] * 3)
    return ArrayCatalog({'RA': ra, 'DEC': dec, 'Redshift': z,
                         'Weight': cat['Weight']}, device='cuda')


def particles_flow():
    """Every particle algorithm once through the user entry points, each
    stage in one CUDA-event window: returns ({stage: result}, {stage:
    ms})."""
    from nbodykit_tpu_torch.cosmology import Planck15
    from nbodykit_tpu_torch.lab import (CylindricalGroups, FiberCollisions,
                                        KDDensity, SimulationBox2PCF,
                                        SimulationBox3PCF,
                                        SimulationBoxPairCount,
                                        SurveyData2PCF, SurveyDataPairCount)
    out, ms = {}, {}

    def step(name, fn):
        out[name], ms[name] = timed(fn)
        return out[name]
    cat, randoms = step('catalogs', particles_catalogs)
    step('box_2pcf_1d', lambda: SimulationBox2PCF('1d', cat, PB_EDGES))
    step('box_2pcf_2d', lambda: SimulationBox2PCF('2d', cat, PB_EDGES,
                                                  Nmu=10))
    step('box_2pcf_projected', lambda: SimulationBox2PCF(
        'projected', cat, PB_RP_EDGES, pimax=PB_PIMAX))
    step('box_cross_1d', lambda: SimulationBoxPairCount(
        '1d', cat, PB_EDGES, second=randoms))
    step('box_3pcf', lambda: SimulationBox3PCF(cat, PB_POLES, PB_3PT_EDGES))
    dsky, rsky = step('sky', lambda: (sky_catalog(cat),
                                      sky_catalog(randoms)))
    step('survey_2pcf_2d', lambda: SurveyData2PCF(
        '2d', dsky, rsky, PB_EDGES, cosmo=Planck15, Nmu=10))
    step('survey_angular', lambda: SurveyDataPairCount('angular', dsky,
                                                       PB_THETA))
    step('fibercollisions', lambda: FiberCollisions(dsky['RA'], dsky['DEC'],
                                                    seed=PB_SEED))
    step('kddensity', lambda: KDDensity(cat))
    step('cgm', lambda: CylindricalGroups(cat, rankby='Mass', rperp=2,
                                          rpar=10, flat_sky_los=[0, 0, 1]))
    return out, ms


def particles_gates(res):
    """The results checked by the estimators' own identities and the
    physics of the sample; returns the numbers read."""
    from nbodykit_tpu_torch.algorithms.paircount_tpcf.estimators import \
        analytic_random_pairs
    cat, randoms = res['catalogs']
    N = len(cat)
    assert abs(N - PB_N) <= 5 * np.sqrt(PB_N), N
    g = {'N': N, 'N_randoms': len(randoms)}
    xi1, xi2 = res['box_2pcf_1d'], res['box_2pcf_2d']
    xi = xi1.corr['corr']
    r = xi1.corr['r']
    assert np.isfinite(xi).all()
    g['xi_1d'] = xi.tolist()
    assert xi[r < 30].mean() > 0.1 and np.abs(xi[r > 100]).max() < 0.1, xi
    # the wedges hold the same pairs: their sum over mu is the 1d count,
    # their mean xi the 1d xi (uniform RR in mu)
    n1, n2 = xi1.D1D2.pairs['npairs'], xi2.D1D2.pairs['npairs']
    assert np.array_equal(n2.sum(axis=-1), n1), (n1, n2.sum(axis=-1))
    xi0 = xi2.corr.to_poles([0])['corr_0']
    g['xi0_wedges_vs_1d_max_abs'] = float(np.abs(xi0 - xi).max())
    assert g['xi0_wedges_vs_1d_max_abs'] <= 1e-9 * np.abs(xi).max()
    wp = res['box_2pcf_projected'].wp['corr']
    assert np.isfinite(wp).all() and wp[0] > wp[-1] > -10, wp
    g['wp'] = wp.tolist()
    cross = res['box_cross_1d']
    expect = analytic_random_pairs('1d', PB_EDGES, 2, np.full(3, PB_BOX)) \
        / 2.0 * N * len(randoms)
    got = cross.pairs['npairs']
    g['cross_pairs_over_uniform'] = float(got.sum() / expect.sum())
    assert abs(g['cross_pairs_over_uniform'] - 1) < 0.01, g
    z3 = res['box_3pcf'].poles
    for ell in PB_POLES:
        z = z3['corr_%d' % ell]
        assert z.shape == (13, 13) and np.isfinite(z).all()
        assert np.abs(z - z.T).max() <= 1e-10 * np.abs(z).max(), ell
    assert (np.diag(z3['corr_0']) > 0).all()
    g['zeta_0_diag'] = np.diag(z3['corr_0']).tolist()
    sxi = res['survey_2pcf_2d']
    for name in ('D1D2', 'D1R2', 'R1R2'):
        assert getattr(sxi, name).pairs['npairs'].sum() > 0, name
    sx = sxi.corr['corr']
    assert np.isfinite(sx).all()
    g['survey_xi0'] = sxi.corr.to_poles([0])['corr_0'].tolist()
    assert np.mean(g['survey_xi0'][:5]) > 0.1, g['survey_xi0']
    ang = res['survey_angular'].pairs['npairs']
    assert (ang > 0).all(), ang
    g['angular_npairs'] = ang.tolist()
    fc = res['fibercollisions'].labels
    coll = fc['Collided'].cpu().numpy()
    nid = fc['NeighborID'].cpu().numpy()
    assert np.array_equal(nid >= 0, coll == 1)
    g['collided_fraction'] = float(coll.mean())
    g['fiber_groups'] = int(fc['Label'].max())
    assert 0 < g['collided_fraction'] < 0.1, g['collided_fraction']
    kd = res['kddensity']
    vol = 4.0 / 3 * np.pi * kd.attrs['kernel_radius'] ** 3
    counts = kd.density * vol
    assert bool(torch.isfinite(kd.density).all())
    assert float(counts.min()) >= 1 - 1e-9
    g['kdd_mean_count'] = float(counts.mean())
    assert 4 < g['kdd_mean_count'] < 40, g['kdd_mean_count']
    groups = res['cgm'].groups
    typ = groups['cgm_type'].cpu().numpy()
    hid = groups['cgm_haloid'].cpu().numpy()
    sat = typ == 1
    assert sat.any() and (typ[hid[sat]] == 0).all()
    assert (hid[~sat] == -1).all()
    g['cgm_satellites'] = int(sat.sum())
    g['cgm_rounds'] = res['cgm'].rounds
    return g


def strided(n, m):
    """Indices of ``m`` queries spread over ``n`` cell-ordered ones."""
    return torch.arange(0, n, max(n // m, 1), device='cuda')[:m]


def candidates(grid, ci1, live1):
    """The candidates the plain fold visits for the live queries in
    cells ``ci1``: the slots of every in-grid neighbour cell, summed
    (an int; the counts of ``ops.gridhash.neighbor_cells``)."""
    from nbodykit_tpu_torch.ops.gridhash import neighbor_cells
    total = 0
    for _, count, oob in neighbor_cells(grid.flat_s, ci1, grid.offsets,
                                        grid.ncell_np, grid.periodic):
        total += int(torch.where(live1 & ~oob, count, 0).sum())
    return total


PC_KW = ('nb2', 'pimax', 'los', 'origin', 'is_auto')


@contextlib.contextmanager
def captured_pair_counts():
    """The (args, kwargs) of every paircount_hist_cuda call inside, in
    order. The wrapper is called through; it counts its launches on the
    module's name, the spy while it is installed, and the count goes
    back to the wrapper on exit."""
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    orig = pc.paircount_hist_cuda
    calls = []

    def spy(*a, **kw):
        calls.append((a[:8], dict(zip(PC_KW, a[8:]), **kw)))
        return orig(*a, **kw)
    spy.launches = orig.launches
    pc.paircount_hist_cuda = spy
    try:
        yield calls
    finally:
        pc.paircount_hist_cuda = orig
        orig.launches = spy.launches


FIRST_DESIGNS = ('paircount_first_design', 'threept_first_design',
                 'fof_links_first_design', 'fof_links_tiles')
_FIRST = {}


LINK_WRAPPERS = ('fof_link_count_cuda', 'fof_link_fill_cuda')


@contextlib.contextmanager
def captured_link_calls():
    """[(wrapper name, args, kwargs)] of every link count and fill call
    inside, in order. The wrappers are called through; each counts its
    launches on the module's name, the spy's while it is installed, and
    the counts go back to the wrappers on exit."""
    from nbodykit_tpu_torch.ops import fof_cuda as fc
    origs = {name: getattr(fc, name) for name in LINK_WRAPPERS}
    calls = []
    spies = {}
    for name, orig in origs.items():
        def spy(*a, name=name, orig=orig, **kw):
            calls.append((name, a, kw))
            return orig(*a, **kw)
        spy.launches = orig.launches
        spies[name] = spy
        setattr(fc, name, spy)
    try:
        yield calls
    finally:
        for name, orig in origs.items():
            setattr(fc, name, orig)
            orig.launches = spies[name].launches


def particles_link_checks(calls):
    """The link kernels on the particles path's inputs, replayed: the
    count and fill of FiberCollisions' FOF (f64 points on the unit
    sphere in a box of 4, open, its capped 4096^3 grid of int64 ids:
    sparse, a column table larger than L2) and KDDensity's f64 count (a
    radius of one mean separation, ~1 point a cell), each on every query
    (``link_kernel_checks``). Returns {kernel: {path: record}}."""
    names = [c[0] for c in calls]
    assert names == ['fof_link_count_cuda', 'fof_link_fill_cuda',
                     'fof_link_count_cuda'], names
    out = {'fof_link_count': {}, 'fof_link_fill': {}}
    for label, (_, a, _), fill in (('fibercollisions', calls[0], True),
                                   ('kddensity', calls[2], False)):
        recs, *_ = link_kernel_checks(label, a[:4], a[4], a[5:10], fill=fill)
        for k, v in recs.items():
            out[k][label] = v
    return out


def first_designs():
    """The first designs of the particle kernels and the FOF link kernels
    (csrc/variants/), built once (``main`` builds them beside the
    kernels): {name: ctypes library}."""
    if not _FIRST:
        from nbodykit_tpu_torch.kernel_variants import _build_variants
        _FIRST.update(_build_variants(FIRST_DESIGNS))
    return _FIRST


def launch_ms(fn, args, reset=(), reps=3):
    """CUDA-event ms of a kernel's launch alone (``fn(*args)`` of a
    ctypes function, the outputs ``reset`` zeroed before each)."""
    from nbodykit_tpu_torch import _build

    def go():
        for o in reset:
            o.zero_()
        _build.check('launch', fn(*args))
    return cuda_ms(go, reps=reps)


def pair_check(label, got, want, plain_ms=None):
    """The kernel's histograms ``got`` against ``want`` (npairs bit for
    bit, wpairs to PB_RTOL of the largest)."""
    (kn, kw), (pn, pw) = got, want
    nd = int((kn != pn).sum())
    err = float((kw - pw).abs().max())
    scale = float(pw.abs().max())
    assert nd == 0, "%s: %d npairs bins differ" % (label, nd)
    assert err <= PB_RTOL * scale, (label, err, scale)
    return dict(case=label, npairs_equal=True, wpairs_max_abs_err=err,
                wpairs_max=scale, plain_ms=plain_ms)


def pair_shape(label, call, lib=None):
    """One pair count of the path, replayed: the kernel on PB_CHECK_PAIRS
    strided queries, in the grid's cell order and shuffled, against the
    plain version; an auto count of the grid's own points counted once a
    pair (as launched) against every query counting every candidate, on
    all queries, and with dead queries against a copy; then the kernel
    (through the wrapper, and with ``lib`` its launch alone and the first
    design, ``lib``, in turns) timed, with the candidates, the bound and
    the share."""
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    args, kwargs = call
    grid, w2_s, p1, w1, live, ci1, r2edges, mode = args
    once = pc.each_pair_once(grid, w2_s, p1, w1, kwargs['is_auto']) \
        and bool(live.all())
    q = strided(p1.shape[0], PB_CHECK_PAIRS)
    sub = (grid, w2_s, p1[q].contiguous(), w1[q].contiguous(), live[q],
           ci1[q].contiguous(), r2edges, mode)
    kern = pc.paircount_hist_cuda(*sub, **kwargs)
    plain, p_ms = timed(lambda: pc.paircount_hist_plain(*sub, **kwargs,
                                                        block=128))
    checks = [pair_check(label + ' strided', kern, plain, p_ms)]
    # the same queries out of the grid's cell order (a seeded shuffle)
    qs = q[torch.randperm(q.numel(), generator=torch.Generator().manual_seed(
        0)).to(q.device)]
    shuffled = (grid, w2_s, p1[qs].contiguous(), w1[qs].contiguous(),
                live[qs], ci1[qs].contiguous(), r2edges, mode)
    checks.append(pair_check(label + ' strided, shuffled',
                             pc.paircount_hist_cuda(*shuffled, **kwargs),
                             plain))
    got = pc.paircount_hist_cuda(*args, **kwargs)
    if once:
        # a copy of the grid's points: every query counts every candidate
        every = pc.paircount_hist_cuda(grid, w2_s, p1.clone(), *args[3:],
                                       **kwargs)
        checks.append(pair_check(label + ' once a pair vs every pair', got,
                                 every))
        # a seventh of the queries dead: the kernel reads so on the card
        # and counts every pair from both ends, as for a copy
        dead = live.clone()
        dead[::7] = False
        checks.append(pair_check(
            label + ' dead queries, own points vs a copy',
            pc.paircount_hist_cuda(grid, w2_s, p1, w1, dead, *args[5:],
                                   **kwargs),
            pc.paircount_hist_cuda(grid, w2_s, p1.clone(), w1, dead,
                                   *args[5:], **kwargs)))
    nb2 = kwargs['nb2']
    nbins = pc.hist_bins(len(r2edges), nb2)
    t = {'first': [], 'kernel': []}
    if lib is not None:
        outs = (torch.zeros(nbins, dtype=torch.int64, device='cuda'),
                torch.zeros(nbins, dtype=torch.float64, device='cuda'))
        largs, keep = pc.launch_args(*args[:8], nb2, kwargs['pimax'],
                                     kwargs['los'], kwargs['origin'],
                                     kwargs['is_auto'], *outs)
        first = lib.nbk_paircount_hist
        first.argtypes = pc.ARGTYPES
        built = pc._fn()
        for name in ('first', 'kernel', 'kernel', 'first'):
            t[name].append(launch_ms(first if name == 'first' else built,
                                     largs, outs))
        assert torch.equal(outs[0].double(), got[0]), label
    ms = cuda_ms(lambda: pc.paircount_hist_cuda(*args, **kwargs), reps=3)
    n = p1.shape[0]
    cand = candidates(grid, ci1, live)
    visited = pc.visited_candidates(cand, n, once)
    ops = visited * pc.candidate_ops(mode, kwargs['los']) \
        + pc.weight_products(visited, n, nbins)
    nbytes = pc.hist_bytes(n, grid.pos_s.shape[0],
                           grid.flat_s.element_size(),
                           grid.columns().numel(), len(r2edges), nb2)
    b_ms, b_by = bound(nbytes, ops, F64_UNFUSED_OPS)
    inrange = int(got[0].reshape(-1, nb2)[1:-1].sum())
    return dict(
        shape=label, mode=mode, los=kwargs['los'], n1=n,
        n2=grid.pos_s.shape[0], periodic=bool(grid.periodic),
        each_pair_once=once, candidates=cand,
        visited=visited, pairs_in_range=inrange, ms=ms,
        kernel_ms=float(np.mean(t['kernel'])) if t['kernel'] else None,
        first_design_ms=float(np.mean(t['first'])) if t['first'] else None,
        bound_ms=b_ms,
        bound_by=b_by, ops=ops, bytes=nbytes, share_of_bound=b_ms / ms,
        checks=checks)


def particles_kernels(cat, calls, stage_ms):
    """Both kernels on the path's shapes: every pair count the flow
    launched (``calls``) checked, timed beside its first design and its
    bound; the 1d auto count against the plain version on all queries;
    the 3PCF moments on the path's first chunk, checked whole and timed
    beside their first design."""
    from nbodykit_tpu_torch.algorithms.threeptcf import CHUNK, se_inputs
    from nbodykit_tpu_torch.ops import paircount_cuda as pc
    from nbodykit_tpu_torch.ops import threept_cuda as tc
    assert len(calls) == len(PB_SHAPES), len(calls)
    libs = first_designs()
    shapes = [pair_shape(label, call, libs['paircount_first_design'])
              for label, call in zip(PB_SHAPES, calls)]
    for s in shapes:
        emit({'phase': 'particles_pair_shape', **s})
    # the 1d auto count, once a pair, against the plain version on every
    # query
    args, kwargs = calls[0]
    got = pc.paircount_hist_cuda(*args, **kwargs)
    want, p_ms = timed(lambda: pc.paircount_hist_plain(*args, **kwargs,
                                                       block=128))
    whole = pair_check('box_1d all %d queries' % args[2].shape[0], got,
                       want, p_ms)
    emit({'phase': 'particles_pair_whole', **whole})
    one = shapes[0]
    worst = max((c for s in shapes for c in s['checks']),
                key=lambda c: c['wpairs_max_abs_err'] / c['wpairs_max'])
    pair_rec = dict(
        ms=one['ms'], kernel_ms=one['kernel_ms'],
        first_design_ms=one['first_design_ms'], plain_ms=p_ms,
        library_ms=None, bound_ms=one['bound_ms'], bound_by=one['bound_by'],
        max_abs_err=max(whole['wpairs_max_abs_err'],
                        worst['wpairs_max_abs_err']),
        at='1d auto, f64, n=%d, %s cells, %d candidates, %d visited, %d '
           'pairs in range' % (one['n1'], 'x'.join(
               str(int(c)) for c in args[0].ncell_np), one['candidates'],
               one['visited'], one['pairs_in_range']),
        whole_check=whole, shapes=shapes)
    del args, got, want

    # threept_alm: the 3PCF's grid and its first chunk, whole
    pos, w = cat['Position'], cat['Weight']
    edges = PB_3PT_EDGES
    grid, w_s, p, live, ci = se_inputs(pos.double(), w, edges,
                                       np.full(3, PB_BOX), True)
    nq = min(CHUNK, p.shape[0])
    chunk = (grid, w_s, p[:nq], live[:nq], ci[:nq], edges ** 2, PB_POLES)
    a = tc.threept_alm_cuda(*chunk)
    b, p3_ms = timed(lambda: tc.threept_alm_plain(*chunk, block=128))
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    assert err <= PB_RTOL * scale, ('threept_alm', err, scale)
    del b
    out = torch.empty_like(a)
    largs, keep = tc.launch_args(*chunk, out)
    first = libs['threept_first_design'].nbk_threept_alm
    first.argtypes = tc.ARGTYPES
    t = {'first': [], 'kernel': []}
    for name in ('first', 'kernel', 'kernel', 'first'):
        t[name].append(launch_ms(first if name == 'first' else tc._fn(),
                                 largs))
    assert float((out - a).abs().max()) <= PB_RTOL * scale
    ms3 = cuda_ms(lambda: tc.threept_alm_cuda(*chunk), reps=3)
    # the chunk's in-bin pairs: a pair count of its queries on its grid
    hn, _ = pc.paircount_hist_cuda(grid, w_s, chunk[2], w_s[:nq],
                                   chunk[3], chunk[4], edges ** 2, '1d',
                                   is_auto=True)
    inbin = int(hn[1:-1].sum())
    cand3 = candidates(grid, chunk[4], chunk[3])
    nlm = len(tc.lm_table(PB_POLES)[0])
    # a candidate as a pair count's without the weight's sum; an in-bin
    # pair's harmonics on the FP64 lanes, their weight products and sums
    # into the moments as a matrix product on the tensor cores
    ops3 = cand3 * (pc.candidate_ops('1d', 2) - 1) \
        + inbin * tc.ylm_ops(PB_POLES)
    mma3 = inbin * tc.ylm_mma_ops(PB_POLES)
    nbytes3 = tc.alm_bytes(nq, p.shape[0], grid.flat_s.element_size(),
                           grid.columns().numel(), len(edges) - 1, nlm)
    b3, b3_by = bound(nbytes3, ops3, F64_UNFUSED_OPS,
                      more=[(mma3, F64_TC_FLOPS)])
    alm_rec = dict(
        ms=ms3, kernel_ms=float(np.mean(t['kernel'])),
        first_design_ms=float(np.mean(t['first'])), plain_ms=p3_ms,
        library_ms=None, bound_ms=b3, bound_by=b3_by, max_abs_err=err,
        alm_max=scale, plain_queries=nq,
        at='poles 0-4 (%d Y_lm), %d bins, chunk of %d queries of n=%d, '
           '%d candidates, %d in-bin pairs' % (nlm, len(edges) - 1, nq,
                                               p.shape[0], cand3, inbin),
        launches_per_3pcf=-(-p.shape[0] // CHUNK), candidates=cand3,
        inbin_pairs=inbin, ops=ops3, tensor_core_ops=mma3, bytes=nbytes3,
        stage_3pcf_ms=stage_ms['box_3pcf'])
    emit({'phase': 'particles_kernels', 'paircount_hist': {
        k: v for k, v in pair_rec.items() if k != 'shapes'},
        'threept_alm': alm_rec})
    return pair_rec, alm_rec


def particles_path():
    """The particles path: the flow once with every kernel's launches
    counted and its peak memory; the gates; the kernel checks and times;
    a profile of the box 2PCF and 3PCF. Returns (launches, paircount
    record, threept record, the link kernels' records)."""
    with counted_launches() as launches, captured_pair_counts() as calls, \
            captured_link_calls() as link_calls:
        torch.cuda.reset_peak_memory_stats()
        res, ms = particles_flow()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    # 2PCF 1d, 2d, projected, the cross count, the survey's DD, DR, RR
    # and the angular count each launch paircount_hist once; the 3PCF
    # once a chunk of its 1e6 queries
    from nbodykit_tpu_torch.algorithms.threeptcf import CHUNK
    N = len(res['catalogs'][0])
    assert launches['paircount_hist'] == 8, launches
    assert launches['threept_alm'] == -(-N // CHUNK), launches
    for k in ('radix_rank', 'threefry_fill', 'poisson_cells',
              'fof_link_count', 'fof_link_fill', 'fof_sweep'):
        assert launches[k] >= 1, "%s was not launched on the particles " \
            "path" % k
    gates = particles_gates(res)
    emit({'phase': 'particles_boss', 'box': PB_BOX, 'nbar': PB_N / PB_BOX ** 3,
          'N': gates['N'], 'stages_ms': ms,
          'total_ms': sum(ms.values()), 'peak_gb': peak / 1e9,
          'launches': launches, 'gates': gates})
    cat, randoms = res['catalogs']
    del res
    torch.cuda.empty_cache()
    from nbodykit_tpu_torch.lab import SimulationBox2PCF, SimulationBox3PCF
    profile_main_path(lambda: (SimulationBox2PCF('1d', cat, PB_EDGES),
                               SimulationBox3PCF(cat, PB_POLES,
                                                 PB_3PT_EDGES)),
                      'particles_boss_2pcf_3pcf')
    del randoms
    pair_rec, alm_rec = particles_kernels(cat, calls, ms)
    link_recs = particles_link_checks(link_calls)
    del link_calls
    return launches, pair_rec, alm_rec, link_recs


# the bispectrum path: the FFT estimator on the main path's catalog at
# 256^3 (564 triangles, alias-free: 2 (16 + 1) <= 256 / 2); the
# agreement of the FFT and direct estimators on the imprinted-weight
# catalog of bench.py's bispectrum bench (1e6 in 1000, f8, nbins 8);
# each numpy oracle of tests/test_bispectrum.py on a small case
BS_BOX, BS_NMESH, BS_NBINS = 1000.0, 256, 16
BS_NPART, BS_CHECK_NBINS, BS_SEED = 10 ** 6, 8, 42
# f64 operations a particle-mode pair of the pairblock sum, unfused as
# F64_UNFUSED_OPS counts them: the phase (3 multiplies, 2 adds), the two
# weighted accumulations (2 multiplies, 2 adds), and sin and cos at 22
# each (a Cody-Waite reduction of 3 and a degree-~9 polynomial of 19 by
# Horner's rule, the least a libm sin or cos takes for |x| < 1e5)
PAIRBLOCK_OPS = 5 + 4 + 2 * 22


def spy_rank_digits(fn):
    """(fn's result, [(digits, D)]): every digit stream the rank pass
    is given while ``fn`` runs, copied."""
    from nbodykit_tpu_torch.ops import radix
    seen, orig = [], radix._rank_hist

    def spy(digit, D):
        seen.append((digit.clone(), D))
        return orig(digit, D)
    radix._rank_hist = spy
    try:
        out = fn()
    finally:
        radix._rank_hist = orig
    return out, seen


def bispectrum_flow(nmesh=BS_NMESH, nbins=BS_NBINS, comm=None):
    from nbodykit_tpu_torch.lab import Bispectrum, UniformCatalog
    cat = UniformCatalog(nbar=1e-2, BoxSize=BS_BOX, seed=42, comm=comm)
    return cat, Bispectrum(cat, nbins=nbins, Nmesh=nmesh, method='fft')


def bispectrum_plan(npart, ndevices=1):
    """memory_plan of the bispectrum path (f8 CIC mxu paint, FFT
    method, BS_NBINS shells): its peak in GB."""
    from nbodykit_tpu_torch.pmesh import memory_plan
    return memory_plan(BS_NMESH, npart, ndevices=ndevices, dtype='f8',
                       paint_method='mxu', workload='bispectrum',
                       nbins=BS_NBINS, bspec_method='fft')['peak_bytes'] / 1e9


def forward_plan(ndevices=1):
    """memory_plan of the forward path's model (f8, the scatter paint of
    grad mode, FW_STEPS steps): its peak in GB."""
    from nbodykit_tpu_torch.pmesh import memory_plan
    return memory_plan(FW_NMESH, FW_NMESH ** 3, ndevices=ndevices,
                       dtype='f8', paint_method='scatter', workload='forward',
                       pm_steps=FW_STEPS)['peak_bytes'] / 1e9


def imprinted_catalog(npart=BS_NPART, L=BS_BOX, seed=BS_SEED, comm=None):
    """bench.py's bispectrum catalog: numpy uniform positions from
    RandomState(seed + 11) and weights (1 + g / 2)^2, g a sum of eight
    low-|q| cosines, as an f8 ArrayCatalog on the card (this rank's rows
    of ``comm``'s ranks)."""
    from nbodykit_tpu_torch.lab import ArrayCatalog
    rng = np.random.RandomState(seed + 11)
    pos = rng.uniform(0.0, L, size=(npart, 3))
    g = np.zeros(npart)
    for m in [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1),
              (1, 0, 1), (2, 0, 0), (1, 1, 1)]:
        ph = rng.uniform(0, 2 * np.pi)
        g += 0.4 * np.cos(2 * np.pi * (pos @ np.array(m)) / L + ph)
    kw = dict(device='cuda') if comm is None else dict(comm=comm)
    return ArrayCatalog({'Position': pos, 'Weight': (1.0 + 0.5 * g) ** 2},
                        BoxSize=L, **kw)


def fft_triangle_oracle(N=16, L=100.0, nbins=4):
    """tests/test_bispectrum.py's all-triangle oracle of the FFT path
    (mod-N closure) against fft_bispectrum on the card, f8."""
    from nbodykit_tpu_torch.algorithms.bispectrum import fft_bispectrum
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    pm = ParticleMesh(N, L, dtype='f8')
    real = np.random.RandomState(42).standard_normal((N, N, N))
    B, ntri = fft_bispectrum(pm, pm.r2c(torch.as_tensor(real,
                                                        device='cuda')),
                             nbins)
    dk = np.fft.fftn(real).reshape(-1) / N ** 3
    fx = np.fft.fftfreq(N, 1.0 / N).astype(int)
    qx, qy, qz = np.meshgrid(fx, fx, fx, indexing='ij')
    q = np.stack([qx, qy, qz], -1).reshape(-1, 3)
    isq = (q ** 2).sum(1)
    sh = np.floor(np.sqrt(isq.astype('f8'))).astype(int) - 1
    pos_of = {tuple(v): i for i, v in enumerate(q)}
    idx = {b: np.flatnonzero((isq >= 1) & (sh == b)) for b in range(nbins)}
    So = np.zeros((nbins,) * 3, complex)
    No = np.zeros((nbins,) * 3)
    for b1 in range(nbins):
        for b2 in range(nbins):
            q2s, d2 = q[idx[b2]], dk[idx[b2]]
            for i1 in idx[b1]:
                q3 = (-(q[i1] + q2s) + N // 2) % N - N // 2
                for i2 in range(len(q2s)):
                    t = pos_of[tuple(q3[i2])]
                    b3 = sh[t]
                    if 0 <= b3 < nbins and isq[t] >= 1:
                        So[b1, b2, b3] += dk[i1] * d2[i2] * dk[t]
                        No[b1, b2, b3] += 1
    return B, ntri, So, No, L ** 3


def direct_triangle_oracle(Np=400, L=100.0, nbins=3):
    """tests/test_bispectrum.py's true-closure oracle of the direct path
    against direct_bispectrum on the card, f8."""
    from nbodykit_tpu_torch.algorithms.bispectrum import (direct_bispectrum,
                                                          shell_modes)
    rng = np.random.RandomState(7)
    pos = rng.uniform(0, L, (Np, 3))
    w = rng.uniform(0.5, 1.5, Np)
    B, ntri = direct_bispectrum(torch.as_tensor(pos, device='cuda'),
                                torch.as_tensor(w, device='cuda'), L, nbins,
                                tile=128)
    q, sh = shell_modes(nbins)
    q = np.concatenate([q, -q])
    sh = np.concatenate([sh, sh])
    kv = q * (2 * np.pi / L)
    d = (w[None, :] * np.exp(-1j * (kv @ pos.T))).sum(1) / w.sum()
    pos_of = {tuple(v): i for i, v in enumerate(q)}
    S = np.zeros((nbins,) * 3, complex)
    No = np.zeros((nbins,) * 3)
    for i1 in range(len(q)):
        for i2 in range(len(q)):
            t = pos_of.get(tuple(-(q[i1] + q[i2])))
            if t is not None:
                S[sh[i1], sh[i2], sh[t]] += d[i1] * d[i2] * d[t]
                No[sh[i1], sh[i2], sh[t]] += 1
    return B, ntri, S, No, L ** 3


def check_oracle(label, B, ntri, S, No, V, rtol):
    Bo = np.where(No > 0, V * V * S.real / np.where(No > 0, No, 1), np.nan)
    assert np.array_equal(np.nan_to_num(ntri, nan=0.0), No), \
        "%s: ntri differs from the oracle's count" % label
    assert np.array_equal(np.isnan(B), No == 0), label
    both = No > 0
    err = float(np.max(np.abs(B[both] - Bo[both]) / np.abs(Bo[both])))
    assert err <= rtol, "%s: B off the oracle by %g > %g" % (label, err,
                                                              rtol)
    return dict(triangles=int(both.sum()), max_rel_err=err, rtol=rtol)


def bispectrum_kernels(cat, nmesh=BS_NMESH):
    """The deposit and the rank pass on the bispectrum's paint (the f8
    CIC mesh that Bispectrum's FFT path paints): the deposit against its
    plain version on the whole payload, bucketed by the radix passes and
    equal to argsort's bucketing; the rank kernel against its plain
    version on every digit stream of that paint; the mxu paint against
    index_add_'s; their times."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.ops.radix_cuda import (pass_rank_hist_cuda,
                                                   pass_rank_hist_plain)
    full = (nmesh,) * 3
    mesh = cat.to_mesh(Nmesh=nmesh, dtype='f8', compensated=True)
    field, digits = spy_rank_digits(lambda: mesh.to_real_field().value)
    assert digits, "the bispectrum's paint ran no rank pass"
    for d, D in digits:
        rk, hk = pass_rank_hist_cuda(d, D)
        rp, hp = pass_rank_hist_plain(d, D)
        assert torch.equal(rk, rp) and torch.equal(hk, hp), \
            "rank pass at D=%d differs from its plain version" % D
    with set_options(paint_method='scatter'):
        plain = mesh.to_real_field().value
    diff = float((plain - field).abs().max())
    fmax = float(field.abs().max())
    assert diff <= 1e-12 * fmax, (diff, fmax)
    del plain, field
    pos = cat['Position'] * (nmesh / BS_BOX)
    mass = torch.ones(pos.shape[0], dtype=torch.float64, device='cuda')
    plan, payload, geom, err, _ = deposit_case(
        'cic %d^3 f8 bispectrum n=%d' % (nmesh, pos.shape[0]), pos, mass,
        full, full, 0, 'cic', check_order=True)
    dep = time_deposit(payload, geom, plan, err)
    del payload
    rank = time_rank(len(cat), D=digits[0][1], digits=digits[0][0],
                     plain_reps=1)
    emit({'phase': 'bispectrum_kernels', 'rank_streams_checked':
          [[int(d.numel()), int(D)] for d, D in digits],
          'mxu_vs_index_add_max_abs': diff, 'field_max': fmax,
          'deposit': dep, 'rank': rank})
    return dep, rank


def triple_sum_timing(cat, nmesh=BS_NMESH, nbins=BS_NBINS):
    """One call of the FFT path's triple sum (three shell-filtered c2r
    and the product's sum) at the path's mesh, against its bound: three
    complex-to-real transforms at 2.5 N log2 N f64 operations each (N
    real cells) at the FMA peak, or the complex field read once."""
    from nbodykit_tpu_torch.algorithms.bispectrum import (_make_triple_sum,
                                                          _shell_edges2)
    c = cat.to_mesh(Nmesh=nmesh, dtype='f8', compensated=True).compute(
        mode='complex')
    triple = _make_triple_sum(c.pm)
    edges2, _ = _shell_edges2(nbins, c.pm.BoxSize)
    e = np.stack([edges2[nbins // 2]] * 3)
    ms = cuda_ms(lambda: triple(c.value, e), reps=10)
    n = float(c.pm.Ntot)
    ops = 3 * 2.5 * n * np.log2(n)
    b_ms, b_by = bound(c.value.numel() * c.value.element_size(), ops,
                       F64_FLOPS)
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, ops=ops,
                share_of_bound=b_ms / ms, at='%d^3 f8, shells %s'
                % (nmesh, e.tolist()))


def bispectrum_agreement(npart=BS_NPART, nmesh=BS_NMESH,
                         nbins=BS_CHECK_NBINS):
    """The FFT and direct estimators on the imprinted-weight catalog: an
    alias-free closure (2 (nbins + 1) <= nmesh / 2), so ntri must be
    identical and B agree to tests/test_bispectrum.py's bar (2e-2 of
    the largest |B|); the pairblock sum's time against its bound and the
    host combination's seconds."""
    from nbodykit_tpu_torch.algorithms.bispectrum import (
        _combine_triangles, shell_modes)
    from nbodykit_tpu_torch.lab import Bispectrum
    from nbodykit_tpu_torch.ops.pairblock import lattice_kvecs, pairblock_sum
    assert 2 * (nbins + 1) <= nmesh // 2
    cat = imprinted_catalog(npart)
    bf, fft_ms = timed(lambda: Bispectrum(cat, nbins=nbins, Nmesh=nmesh,
                                          method='fft'))
    bd, direct_ms = timed_host(lambda: Bispectrum(cat, nbins=nbins,
                                                  method='direct'))
    Bf, Bd = bf.B['B'], bd.B['B']
    same = np.array_equal(np.nan_to_num(bf.B['ntri'], nan=-1.0),
                          np.nan_to_num(bd.B['ntri'], nan=-1.0))
    m = ~np.isnan(Bf)
    scale = float(np.abs(Bd[m]).max())
    err = float(np.max(np.abs(Bf[m] - Bd[m])))
    ok = bool(np.allclose(Bf[m], Bd[m], rtol=2e-2, atol=2e-2 * scale))

    pos, w = cat['Position'], cat['Weight']
    q, shell = shell_modes(nbins)
    kv = lattice_kvecs(q, BS_BOX)
    modes = pairblock_sum(pos, w, kv)
    pb_ms = cuda_ms(lambda: pairblock_sum(pos, w, kv), reps=3)
    pairs = float(npart) * len(kv)
    b_ms, b_by = bound(npart * 4 * 8 + len(kv) * 3 * 8 + len(kv) * 16,
                       pairs * PAIRBLOCK_OPS, F64_UNFUSED_OPS)
    d_half = modes.cpu().numpy() / float(w.sum())
    full_q = np.concatenate([q, -q])
    delta = np.concatenate([d_half, np.conj(d_half)])
    _, host_ms = timed_host(lambda: _combine_triangles(
        full_q, np.concatenate([shell, shell]), delta, nbins))
    rec = {'phase': 'bispectrum_agreement', 'npart': npart, 'nmesh': nmesh,
           'nbins': nbins, 'triangles': int(m.sum()),
           'ntri_identical': same, 'max_abs_B_diff': err,
           'max_abs_B': scale, 'atol': 2e-2 * scale, 'agree': ok,
           'fft_ms': fft_ms, 'direct_host_ms': direct_ms,
           'pairblock': dict(ms=pb_ms, bound_ms=b_ms, bound_by=b_by,
                             share_of_bound=b_ms / pb_ms, pairs=pairs,
                             modes=len(kv), ops_per_pair=PAIRBLOCK_OPS,
                             library_ms=None),
           'combine_host_s': host_ms / 1e3}
    emit(rec)
    assert same, "FFT and direct ntri differ on an alias-free closure"
    assert ok, "FFT and direct B differ by %g > 2e-2 * %g" % (err, scale)
    return bf, rec


def bispectrum_path():
    """The bispectrum path: the user flow once with every kernel's
    launches counted, then its median of 3 calls after a warm-up, ms a
    triangle, the paint's ms and the peak; the kernels on its paint; the
    FFT/direct agreement; the numpy oracles. Returns (launches,
    {deposit, rank} records, triple-sum and pairblock records)."""
    from nbodykit_tpu_torch.algorithms.bispectrum import triangle_bins
    t0 = time.perf_counter()
    with counted_launches() as launches:
        cat, r = bispectrum_flow()
    for k in ('threefry_fill', 'paint_deposit', 'radix_rank'):
        assert launches[k] >= 1, "%s was not launched on the bispectrum " \
            "path" % k
    ntri, B = r.B['ntri'], r.B['B']
    closed = ~np.isnan(ntri)
    ncanon = len(triangle_bins(BS_NBINS))
    assert np.array_equal(closed, ~np.isnan(B))
    assert np.isfinite(B[closed]).all() and (ntri[closed] >= 1).all()
    for perm in ((0, 2, 1), (1, 0, 2), (2, 1, 0)):
        assert np.array_equal(np.nan_to_num(ntri), np.nan_to_num(
            ntri.transpose(perm)))
    _, run, peak = peak_of(lambda: bispectrum_flow()[1])
    mesh = cat.to_mesh(Nmesh=BS_NMESH, dtype='f8', compensated=True)
    _, paint = spread(lambda: mesh.to_real_field(), REPS)
    del mesh
    plan = bispectrum_plan(len(cat))
    emit({'phase': 'bispectrum_256', 'npart': len(cat), 'nmesh': BS_NMESH,
          'nbins': BS_NBINS, 'triangles': ncanon, 'launches': launches,
          'run_ms': run, 'ms_per_triangle': run['median'] / ncanon,
          'paint_ms': paint, 'peak_gb': peak, 'memory_plan_peak_gb': plan,
          'peak_over_plan': peak / plan})
    dep, rank = bispectrum_kernels(cat)
    triple = triple_sum_timing(cat)
    del cat, r
    torch.cuda.empty_cache()
    bf, agree = bispectrum_agreement()
    # the counts are the mesh's, whatever the field: nbins 8 of the
    # 16-bin run equal the agreement run's
    k = BS_CHECK_NBINS
    assert np.array_equal(np.nan_to_num(ntri[:k, :k, :k], nan=-1.0),
                          np.nan_to_num(bf.B['ntri'], nan=-1.0))
    oracles = {'fft': check_oracle('fft oracle', *fft_triangle_oracle(),
                                   rtol=1e-6),
               'direct': check_oracle('direct oracle',
                                      *direct_triangle_oracle(), rtol=1e-10)}
    emit({'phase': 'bispectrum_checks', 'triple_sum': triple,
          'oracles': oracles,
          'path_s': time.perf_counter() - t0})
    return launches, dict(deposit=dep, rank=rank), dict(
        triple_sum=triple, pairblock=agree['pairblock'])


# the forward path: the JAX package's 128^3 inference configuration
# (tests/test_forward.py test_recovery_beats_fftrecon_128), f8
FW_NMESH, FW_STEPS, FW_DELTA_RMS = 128, 2, 0.36
FW_ADAM_STEPS, FW_LR, FW_NOISE = 40, 0.01, 0.1
# the finite-difference check of docs/FORWARD.md: eps 1e-6 at f8, on a
# 32^3 model, at tests/test_forward.py's bar for the whole pipeline
FD_NMESH, FD_EPS, FD_RTOL = 32, 1e-6, 1e-4


def forward_fd_check(nmesh=FD_NMESH, comm=None):
    """The directional derivative of the loss along a unit whitenoise
    direction against central differences (with a ``comm``, across its
    ranks)."""
    from nbodykit_tpu_torch.forward import ForwardModel, make_loss
    from nbodykit_tpu_torch.parallel.runtime import global_sum
    model = ForwardModel(nmesh, nmesh ** 3, BoxSize=1000.0,
                         pm_steps=FW_STEPS, dtype='f8', comm=comm)
    lat = model.lattice
    with torch.no_grad():
        obs = model.density(model.linear_modes(1))
        w = lat.c2r(lat.generate_whitenoise(3)) * 0.2
        d = lat.c2r(lat.generate_whitenoise(5))
        d = d / torch.sqrt(global_sum(d * d, comm))
    loss = make_loss(model, obs, noise_std=0.5)
    x = w.clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = (float(loss(w + FD_EPS * d)) - float(loss(w - FD_EPS * d))) \
            / (2.0 * FD_EPS)
    dot = float(global_sum(g * d, comm))
    err = abs(fd - dot) / max(abs(fd), abs(dot), 1e-10)
    assert err <= FD_RTOL, "FD %r vs grad %r (rel %.3g)" % (fd, dot, err)
    return dict(nmesh=nmesh, eps=FD_EPS, fd=fd, grad_dot=dot, rel_err=err,
                rtol=FD_RTOL)


# the custom-VJP paints against the scatter (native autograd) gradient
# at the linear start, f8: the same analytic adjoint, summed in other
# (atomic) orders
FW_VJP_RTOL = 1e-9


def custom_vjp_checks(nmesh, obs, w0, ref_val, ref_grad):
    """One value and gradient of the loss at the displaced latent ``w0``
    with each paint JAX wraps in ``jax.custom_vjp`` (sort, segsum,
    streams; ``PaintAdjoint`` here), against the scatter model's, with
    its times (one warm-up, then LN_REPS calls) and launches."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.forward import ForwardModel, make_loss
    out = {}
    with counted_launches() as launches:
        for method in ('sort', 'segsum', 'streams'):
            with set_options(paint_method=method):
                model = ForwardModel(nmesh, nmesh ** 3, BoxSize=1000.0,
                                     pm_steps=FW_STEPS,
                                     delta_rms=FW_DELTA_RMS, dtype='f8')
            cfg = model.paint_cfg
            assert (cfg['paint_method'], cfg['adjoint_mode']) == \
                (method, 'custom_vjp'), cfg
            loss = make_loss(model, obs, noise_std=FW_NOISE)

            def value_and_grad():
                x = w0.clone().requires_grad_(True)
                val = loss(x)
                return val.detach(), torch.autograd.grad(val, x)[0]
            (val, g), t = spread(value_and_grad, LN_REPS)
            val_err = abs(float(val) - ref_val) / abs(ref_val)
            grad_err = float((g - ref_grad).abs().max()
                             / ref_grad.abs().max())
            assert val_err <= FW_VJP_RTOL and grad_err <= FW_VJP_RTOL, \
                (method, val_err, grad_err)
            out[method] = dict(value_and_grad_ms=t, value_rel_err=val_err,
                               grad_rel_err=grad_err)
            del model, loss, g
    # segsum orders with the radix sort on the card
    assert launches['radix_rank'] >= 1, launches
    return out, launches


def forward_path(nmesh=FW_NMESH, steps=FW_ADAM_STEPS):
    """The forward path: the 128^3 model's truth, observation and
    linear start with every kernel's launches counted; the density's and
    one value-and-gradient's times and peaks; the custom-VJP paints'
    value and gradient against it; 40 Adam steps against FFTRecon on
    mean_cross_correlation; the FD check at 32^3."""
    from nbodykit_tpu_torch.forward import (ForwardModel, fftrecon_baseline,
                                            linear_init, make_loss,
                                            mean_cross_correlation,
                                            recover)
    t0 = time.perf_counter()
    with counted_launches() as launches:
        model = ForwardModel(nmesh, nmesh ** 3, BoxSize=1000.0,
                             pm_steps=FW_STEPS, delta_rms=FW_DELTA_RMS,
                             dtype='f8')
        with torch.no_grad():
            truth = model.linear_modes(0)
            obs = model.density(truth)
            w0 = linear_init(model, obs)
            pos, _ = model.evolve(truth)
            base = fftrecon_baseline(model, pos)
        (w, losses), recover_ms = timed(lambda: recover(
            model, obs, steps=steps, lr=FW_LR, noise_std=FW_NOISE,
            white0=w0))
    cfg = model.paint_cfg
    assert (cfg['paint_method'], cfg['source'], cfg['winner_name']) == \
        ('scatter', 'grad-fallback', 'mxu'), cfg
    # the draws of the truth; the FFTRecon baseline's mxu paints
    for k in ('threefry_fill', 'paint_deposit', 'radix_rank'):
        assert launches[k] >= 1, "%s was not launched on the forward " \
            "path" % k
    lat = model.lattice
    with torch.no_grad():
        r_rec = float(mean_cross_correlation(
            lat, model.modes_from_white(w), truth))
        r_base = float(mean_cross_correlation(lat, base, truth))
        r_start = float(mean_cross_correlation(
            lat, model.modes_from_white(w0), truth))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert r_rec > r_base, \
        "recovered r=%.4f does not beat FFTRecon r=%.4f" % (r_rec, r_base)

    loss = make_loss(model, obs, noise_std=FW_NOISE)

    def value_and_grad():
        x = w0.clone().requires_grad_(True)
        val = loss(x)
        return val.detach(), torch.autograd.grad(val, x)[0]

    def density():
        with torch.no_grad():
            return model.density(truth)
    _, dens, dens_peak = peak_of(density)
    (ref_val, ref_grad), vg, vg_peak = peak_of(value_and_grad)
    vjp, vjp_launches = custom_vjp_checks(nmesh, obs, w0, float(ref_val),
                                          ref_grad)
    for k, v in vjp_launches.items():
        launches[k] += v
    fd = forward_fd_check()
    plan = forward_plan()
    emit({'phase': 'forward_128', 'nmesh': nmesh, 'npart': model.npart,
          'memory_plan_peak_gb': plan,
          'value_and_grad_peak_over_plan': vg_peak / plan,
          'pm_steps': FW_STEPS, 'delta_rms': FW_DELTA_RMS,
          'paint_method': cfg['paint_method'], 'paint_source': cfg['source'],
          'demoted': cfg['winner_name'], 'launches': launches,
          'density_ms': dens, 'density_peak_gb': dens_peak,
          'value_and_grad_ms': vg, 'value_and_grad_peak_gb': vg_peak,
          'grad_over_density': vg['median'] / dens['median'],
          'adam_steps': steps, 'lr': FW_LR, 'loss_first': losses[0],
          'loss_last': losses[-1], 'r_recovered': r_rec,
          'r_fftrecon': r_base, 'r_linear_start': r_start,
          'ms_per_adam_step': recover_ms / steps, 'fd_check': fd,
          'custom_vjp': vjp, 'custom_vjp_rtol': FW_VJP_RTOL,
          'custom_vjp_launches': vjp_launches,
          'path_s': time.perf_counter() - t0})
    return launches


def dist_nccl():
    """``chip_smoke.py --dist-nccl``, on a host of 4 or more cards:
    builds the main path's kernels, then ``dist_main`` over NCCL, one
    rank a card, held against the one-rank run on card 0. The one-card
    run without arguments never takes this path."""
    from nbodykit_tpu_torch import _build
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    count = torch.cuda.device_count()
    assert count >= max(DIST_RANKS), \
        "--dist-nccl needs %d cards, found %d" % (max(DIST_RANKS), count)
    name = torch.cuda.get_device_name(0)
    smi = smi_query('name,power.limit')
    t0 = time.perf_counter()
    _build.build_all(list(DIST_KERNELS))
    emit({'phase': 'device', 'name': name, 'nvidia_smi': smi,
          'count': count, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_s': time.perf_counter() - t0})
    nmesh = 512
    run = main_run(UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42),
                   nmesh)
    run()                                            # warm-up
    launches, kernels = dist_main(run, nmesh, backend='nccl')
    emit({'kernels_nccl': {'launches': launches, 'by_ranks': kernels}})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': count}})
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:] == ['--dist-nccl']:
        return dist_nccl()
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--dist-nccl]", file=sys.stderr)
        return 2
    from nbodykit_tpu_torch import _build
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')

    name = torch.cuda.get_device_name(0)
    smi = smi_query('name,power.limit')
    # the CUDA kernels; class_path builds and times the Boltzmann library
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        firsts = pool.submit(first_designs)
        logs = _build.build_all(_build.sources())
        firsts.result()
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
    # the same catalog across 2 and 4 ranks sharing the card
    dist_launches, dist_kernels = dist_main(run, nmesh)
    del run
    torch.cuda.empty_cache()
    # the other paint families and bf16 storage on the same catalog
    pf_launches, keys = paint_families(cat, nmesh)
    segsum_rank = segsum_rank_row(keys, nmesh)
    del keys
    torch.cuda.empty_cache()
    bf_launches = mesh_bf16(cat, nmesh)
    del cat
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
    # the device only: with the host's ops the profile took ~58 s beyond
    # its run (PERF.md section 4)
    profile_main_path(lambda: convpower_algorithm(cp_mesh),
                      'convpower_1024', host_ops=False)
    cp_dep, cp_rank = convpower_kernels(cp_mesh)
    del cp_mesh
    torch.cuda.empty_cache()

    fof_cat, fof_launches, (fof_recs, fof_rank) = fof_path()
    fof_stages(fof_cat)
    profile_main_path(lambda: fof_algorithm(fof_cat), 'fof_1024')
    rc_launches = fftrecon_path(fof_cat)
    torch.cuda.empty_cache()
    # last: the same catalog saved and reloaded (bigfile)
    io_launches = io_path(fof_cat)
    del fof_cat
    torch.cuda.empty_cache()
    # the particle algorithms on the boss_like sample
    pb_launches, pb_pair, pb_alm, pb_links = particles_path()
    for k, by_path in pb_links.items():
        for label, rec in by_path.items():
            fof_recs[k]['at_' + label] = rec
    torch.cuda.empty_cache()
    # the bispectrum, then the forward model
    t0 = time.perf_counter()
    bs_launches, bs_kernels, bs_torch = bispectrum_path()
    torch.cuda.empty_cache()
    fw_launches = forward_path()
    torch.cuda.empty_cache()
    emit({'phase': 'bispectrum_and_forward', 'seconds':
          time.perf_counter() - t0})

    paths = ('main_512', 'paint_families_512', 'mesh_bf16_512',
             'lognormal_1024', 'class_1024', 'convpower_1024',
             'fof_1024', 'fftrecon_512', 'io_1024', 'particles_boss',
             'bispectrum_256', 'forward_128') + tuple(dist_launches)

    def counted(name):
        by_path = dict(zip(paths, (launches[name], pf_launches[name],
                                   bf_launches[name], ln_launches[name],
                                   cl_launches[name], cp_launches[name],
                                   fof_launches[name],
                                   rc_launches[name], io_launches[name],
                                   pb_launches[name], bs_launches[name],
                                   fw_launches[name]) + tuple(
                                       d[name] for d in
                                       dist_launches.values())))
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
    def at_dist(key, label, ranks=None):
        """Rank 0's record of a kernel on a dist phase, at each P (of
        ``ranks``, where the phase runs at those only)."""
        return {'at_%s_P%d' % (label, p): k[key]
                for p, k in dist_kernels.items()
                if ranks is None or p in ranks}
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
             at_convpower_1024=cp_rank, at_fof_1024=fof_rank,
             at_bispectrum_256=bs_kernels['rank'],
             at_segsum_512=segsum_rank,
             **{'at_dist_main_P%d' % p: k['rank']
                for p, k in dist_kernels.items()},
             **{'at_dist_convpower_P%d' % p: k['cp_rank']
                for p, k in dist_kernels.items() if 'cp_rank' in k},
             **{'at_dist_bispectrum_P%d' % p: k['bs_rank']
                for p, k in dist_kernels.items()},
             **{'at_dist_forward_P%d' % p: k['fw_rank']
                for p, k in dist_kernels.items()},
             **{'at_dist_fof_P%d' % p: k['fof_rank']
                for p, k in dist_kernels.items()},
             **{'at_dist_particles_P%d' % p: k['pt_rank']
                for p, k in dist_kernels.items()},
             **{'at_dist_%s_P%d' % (label, p): k['gr_rank_' + label]
                for p, k in dist_kernels.items()
                for label in ('3pcf', 'cgm', 'fibercollisions')},
             **at_dist('tk_rank', 'dist_tasks', DTK_RANKS)),
        dict(name='paint_deposit', route='cuda',
             source='nbodykit_tpu_torch/csrc/paint_deposit.cu',
             replaces='nbodykit_tpu/ops/paint_pallas.py:37',
             **counted('paint_deposit'), **dep_rec,
             at_convpower_1024=cp_dep,
             at_bispectrum_256=bs_kernels['deposit'],
             **{'at_dist_main_P%d' % p: k['deposit']
                for p, k in dist_kernels.items()},
             **{'at_dist_convpower_P%d' % p: k['cp_deposit']
                for p, k in dist_kernels.items() if 'cp_deposit' in k},
             **{'at_dist_recon_P%d' % p: k['rc_deposit']
                for p, k in dist_kernels.items()},
             **{'at_dist_bispectrum_P%d' % p: k['bs_deposit']
                for p, k in dist_kernels.items()},
             **at_dist('tk_deposit', 'dist_tasks', DTK_RANKS)),
        dict(name='threefry_fill', route='cuda', source=rng_src,
             replaces=rng_replaces, **counted('threefry_fill'), **tf_rec,
             **at_dist('gr_threefry_fill', 'dist_populate')),
        dict(name='poisson_threefry', route='cuda', source=rng_src,
             replaces=rng_replaces, **poisson_counted(),
             **pois_modes['occupied_cells'], modes=pois_modes,
             **at_dist('gr_poisson_threefry', 'dist_populate')),
        dict(name='fof_sweep', route='cuda', source=fof_src,
             replaces=fof_replaces, **fof_sweep_counted(),
             **fof_recs['fof_sweep'], **at_dist('fof_sweep', 'dist_fof'),
             **at_dist('gr_fof_sweep', 'dist_fibercollisions')),
        dict(name='fof_link_count', route='cuda', source=fof_src,
             replaces=fof_replaces, **counted('fof_link_count'),
             **fof_recs['fof_link_count'],
             **at_dist('fof_link_count', 'dist_fof'),
             **at_dist('kdd_link_count', 'dist_particles_kddensity'),
             **at_dist('gr_fof_link_count', 'dist_fibercollisions')),
        dict(name='fof_link_fill', route='cuda', source=fof_src,
             replaces=fof_replaces, **counted('fof_link_fill'),
             **fof_recs['fof_link_fill'],
             **at_dist('fof_link_fill', 'dist_fof'),
             **at_dist('gr_fof_link_fill', 'dist_fibercollisions')),
        dict(name='paircount_hist', route='cuda',
             source='nbodykit_tpu_torch/csrc/paircount.cu',
             replaces=('nbodykit_tpu/algorithms/pair_counters/core.py:103 '
                       '_fold_body (XLA gathers and bincounts; no Pallas '
                       'kernel)'), **counted('paircount_hist'), **pb_pair,
             **at_dist('paircount', 'dist_particles')),
        dict(name='threept_alm', route='cuda',
             source='nbodykit_tpu_torch/csrc/threept_alm.cu',
             replaces=('nbodykit_tpu/algorithms/threeptcf.py:58 the fold '
                       'body of chunk_zeta (XLA; no Pallas kernel)'),
             **counted('threept_alm'), **pb_alm,
             **at_dist('gr_threept_alm', 'dist_3pcf')),
    ]
    for kern in kernels:
        kern['share_of_bound'] = kern['bound_ms'] / kern['ms']
    # the bispectrum's torch stages: no hand kernel (the JAX package runs
    # them through XLA); their times beside their bounds
    emit({'phase': 'bispectrum_torch_stages', **bs_torch})
    emit({'kernels': kernels})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
