"""Time the design steps of the hand-written kernels on one CUDA card.

Each variant is a kernel source of ``csrc/`` with one design step taken
back by a text substitution. The variants are built with the same
``nvcc`` flags as the kernels, into ``_build/variants/``, and timed
beside the kernel as built at the main path's shapes: the rank pass on
9,998,863 int32 digits of alphabet 65, the deposit on the CIC payload
of ``UniformCatalog(nbar=1e-2, BoxSize=1000, seed=42)`` at 512^3. Run
from the repository root on a CUDA machine::

    python -m nbodykit_tpu_torch.kernel_variants

It prints one JSON line per timing: the mean CUDA-event time of 20
launches into preallocated outputs, the kernels in turn (as built,
each variant, as built again), and whether the variant's result
matches (ranks bit for bit, blocks within 1e-5 of their maximum).
Without CUDA it exits 1.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from . import _build

VARIANT_DIR = os.path.join(_build.BUILD_DIR, 'variants')

BALLOT_PEERS = '''    unsigned peers = 0xffffffffu;
    for (int b = 0; b < nbits; ++b) {
      const unsigned bit = (key >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }'''
FAST_PMOD = '''  int r = a;
  if (r < 0) r += n;
  if (r >= n) r -= n;
  if ((unsigned)r < (unsigned)n) return r;
  r = a % n;'''

# name: (source, [(text, replacement)], what the substitution takes back)
VARIANTS = {
    'rank_match_any': ('radix_rank', [
        (BALLOT_PEERS,
         '    const unsigned peers = __match_any_sync(0xffffffffu, key);')],
        'peer masks from __match_any_sync instead of one ballot per bit'),
    'rank_256_threads': ('radix_rank', [
        ('#define RANK_THREADS 512', '#define RANK_THREADS 256')],
        'CTAs of 256 threads and 4096 digits'),
    'rank_one_load_in_flight': ('radix_rank', [
        ('#define SUM_BATCH 8 ', '#define SUM_BATCH 1 ')],
        'look-back sums with one load in flight per thread'),
    'rank_no_min_blocks': ('radix_rank', [
        ('__launch_bounds__(RANK_THREADS, 3)',
         '__launch_bounds__(RANK_THREADS)')],
        'no register cap for three resident CTAs per SM'),
    'deposit_pmod_division': ('paint_deposit', [
        (FAST_PMOD, '  int r = a % n;')],
        'every window index wrapped by an integer division'),
    'deposit_generic_atomics': ('paint_deposit', [
        ('          atomicAdd(tile + col * zc + zl[c], w * tm.wz[c]);',
         '          { A* g = tile; asm volatile("" : "+l"(g));'
         ' atomicAdd(g + col * zc + zl[c], w * tm.wz[c]); }')],
        'atomics through a pointer the compiler cannot see is shared'),
    'deposit_no_staging': ('paint_deposit', [
        ('#define STAGE_WORDS 56 ', '#define STAGE_WORDS 7 ')],
        'one slot a thread loaded while the copies drain, the rest '
        'loaded in the deposit'),
}


def _build_variants(names):
    """Build the named variants, one nvcc each, all together; returns
    {name: ctypes library}."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, subs, _ = VARIANTS[name]
        with open(os.path.join(_build.SRC_DIR, src + '.cu')) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError("variant %s: %r not in %s.cu"
                                   % (name, old[:40], src))
            text = text.replace(old, new)
        cu = os.path.join(VARIANT_DIR, name + '.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(VARIANT_DIR, 'lib%s.so' % name)
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc()] + _build.FLAGS + ['-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (name, out))
        libs[name] = ctypes.CDLL(so)
    return libs


def _ms(fn, reps=20):
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


def _rank_case():
    from .ops import radix_cuda
    n, D = 9998863, 65
    gen = torch.Generator(device='cuda')
    gen.manual_seed(11)
    d = torch.randint(0, D, (n,), generator=gen, device='cuda',
                      dtype=torch.int32)
    ref, _ = radix_cuda.pass_rank_hist_cuda(d, D)
    rank = torch.empty_like(d)
    hist = torch.empty(D, dtype=torch.int32, device='cuda')
    # room for the smallest chunk any variant takes
    scratch = torch.empty(radix_cuda.rank_plan(2 * n, D)['scratch_words'],
                          dtype=torch.int64, device='cuda')
    bad = torch.zeros((), dtype=torch.int32, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        fn = lib.nbk_rank_pass
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        return lambda: _build.check('radix_rank', fn(
            d.data_ptr(), rank.data_ptr(), hist.data_ptr(),
            scratch.data_ptr(), bad.data_ptr(), n, D, stream))

    def same():
        return bool(torch.equal(rank, ref))
    return run, same


def _deposit_case():
    from .ops.paint import mxu_payload, mxu_plan
    from .ops.paint_cuda import deposit_blocks_cuda, deposit_plan
    from .source.catalog import UniformCatalog
    nmesh = 512
    cat = UniformCatalog(nbar=1e-2, BoxSize=1000.0, seed=42)
    pos = cat['Position'] * (nmesh / 1000.0)
    mass = torch.ones(pos.shape[0], dtype=torch.float32, device='cuda')
    full = (nmesh,) * 3
    mp = mxu_plan(pos.shape[0], full, 'cic', full, 4)
    sx, sy, sz, sm, _ = mxu_payload(pos, mass, mp, 'cic', 0, 'radix')
    geom = dict(resampler='cic', rb=mp['rb'], cb=mp['cb'], n0l=nmesh,
                p0=nmesh, N1=nmesh, N2=nmesh, origin=0)
    ref = deposit_blocks_cuda(sx, sy, sz, sm, **geom)
    out = torch.empty_like(ref)
    T, nty, K = sx.shape
    M = ref.shape[2]
    plan = deposit_plan(M, nmesh, 4)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        fn = lib.nbk_deposit
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        return lambda: _build.check('paint_deposit', fn(
            sx.data_ptr(), sy.data_ptr(), sz.data_ptr(), sm.data_ptr(),
            out.data_ptr(), 1, 0, 2, T, nty, K, mp['rb'], mp['cb'], nmesh,
            nmesh, nmesh, nmesh, 0, plan['zc'], plan['nz'],
            plan['smem_bytes'], stream))

    def same():
        return float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    return run, same


def main():
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': smi}), flush=True)
    _build.build_all()
    libs = _build_variants(sorted(VARIANTS))
    for kernel, case in (('radix_rank', _rank_case),
                         ('paint_deposit', _deposit_case)):
        run, same = case()
        names = [n for n in sorted(VARIANTS) if VARIANTS[n][0] == kernel]
        built = run(_build.load(kernel))
        order = [('as_built', built)] + [(n, run(libs[n])) for n in names] \
            + [('as_built', built)]
        for name, fn in order:
            ms = _ms(fn)
            rec = {'kernel': kernel, 'variant': name, 'ms': ms,
                   'matches': same()}
            if name in VARIANTS:
                rec['takes_back'] = VARIANTS[name][2]
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
