"""Rank programs of the multi-rank CPU tests of the torch port.

``run_world(program, nprocs, args=())`` spawns ``nprocs`` processes
(the ``spawn`` start method), joins them into a gloo world through a
file in a temporary directory (no fixed port, so concurrent test
workers do not collide), runs ``program(rank, *args)`` on each with one
torch thread and the port on the CPU, and returns each rank's result. A
rank that raises fails the whole world: the others are stopped and the
traceback is raised in the caller. Each test file spawns one world of
its program: ``parallel_cases`` (test_torch_parallel.py),
``exchange_cases``, ``paint_cases``, ``fftpower_cases``,
``survey_cases``, ``forward_program`` and ``inference_program`` (the
test_torch_dist_*.py files).

This module imports only the standard library, numpy, torch and the
port: a spawned rank imports it, and must not import JAX.

The programs answer every case on ``cpu_mesh(1)``, ``cpu_mesh(2)`` and
``cpu_mesh(4)`` of one 4-rank world; a result is keyed ``(case, P)``
and holds this rank's part as numpy. The inputs are made here from
seeds, so the tests hand the same arrays to the JAX package.
"""

import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_COUNTS = (1, 2, 4)
WORLD = 4

# -- inputs (numpy, seeded) ---------------------------------------------------

BOX = 50.0
NMESH = 32
NPARTS = (4096, 4099)       # divisible by 2 and 4, and not
HALO_WIDTHS = (1, 2, 3)
HALO_ROWS = 8               # interior rows a rank
FFT_SHAPE = (16, 12, 10)
SMALL_CAPACITY = 16
PAINT_CASES = (('scatter', 'cic'), ('sort', 'cic'), ('mxu', 'cic'),
               ('mxu', 'tsc'), ('segsum', 'cic'), ('streams', 'cic'))
# the main path's paints: held to JAX's multi-device paint at every P
PAINT_AT_P = (('scatter', 'cic'), ('mxu', 'cic'))
READOUT_WINDOWS = ('cic', 'tsc')
A2A_MODES = ('bf16', 'int16')


def particles(n, seed=3):
    rs = np.random.RandomState(seed)
    return {'pos': rs.uniform(0, BOX, (n, 3)),
            'mass': rs.uniform(0.5, 1.5, n),
            'dest': rs.randint(0, 4, n).astype('i4')}


def halo_blocks(P, h, seed=5):
    """(P * (n0 + 2h), 4, 5) extended blocks and (P * n0, 4, 5)
    interiors, rank-major."""
    rs = np.random.RandomState(seed + 10 * h + P)
    ext = rs.standard_normal((P * (HALO_ROWS + 2 * h), 4, 5))
    return ext, rs.standard_normal((P * HALO_ROWS, 4, 5))


def fft_inputs(seed=7):
    rs = np.random.RandomState(seed)
    return {'real': rs.standard_normal(FFT_SHAPE),
            'cplx': rs.standard_normal(FFT_SHAPE)
            + 1j * rs.standard_normal(FFT_SHAPE)}


def readout_field(seed=9):
    return np.random.RandomState(seed).standard_normal((NMESH,) * 3)


def rows(a, P, r):
    """Rank r's rows of a global array (the row split)."""
    from nbodykit_tpu_torch.parallel.runtime import row_range
    start, stop = row_range(len(a), P, r)
    return a[start:stop]


def slab(a, P, r):
    n = a.shape[0] // P
    return a[r * n:(r + 1) * n]


# -- the tests' views of a world's results (numpy only) -------------------------

def parts(world, key, P):
    """Each rank's result of case ``key`` at P ranks, in rank order."""
    return [world[r][key + (P,)] for r in range(P)]


def close(got, want, rtol):
    """``got`` within ``rtol`` of ``want``'s largest absolute value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# -- the world ----------------------------------------------------------------

def _rank_main(rank, world, init_file, program, q, args=()):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # every rank is on this host: gloo's sockets on the loopback device
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    try:
        import nbodykit_tpu_torch
        from nbodykit_tpu_torch.parallel.runtime import init_distributed
        nbodykit_tpu_torch.set_options(device='cpu')
        init_distributed(init_method='file://' + init_file,
                         num_processes=world, process_id=rank,
                         backend='gloo', device='cpu', timeout_s=120)
        out = globals()[program](rank, *args)
        q.put((rank, True, out))
    except Exception:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(program, nprocs=WORLD, timeout=240, args=()):
    """Each rank's ``program(rank, *args)`` result, in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='nbk-torch-world-')
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, os.path.join(tmp, 'init'),
                               program, q, tuple(args)))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        results = {}
        deadline = time.monotonic() + timeout
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = q.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise TimeoutError("ranks %s did not finish in %d s"
                                   % (sorted(set(range(nprocs))
                                             - set(results)), timeout))
            if not ok:
                raise RuntimeError("rank %d failed:\n%s" % (rank, payload))
            results[rank] = payload
        for p in procs:
            p.join(timeout=30)
        assert not any(p.is_alive() for p in procs)
        return [results[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _meshes():
    """(P, mesh) for each rank count this rank takes part in (every rank
    creates every group, in the same order)."""
    from nbodykit_tpu_torch.parallel.runtime import cpu_mesh
    meshes = [(P, cpu_mesh(P)) for P in RANK_COUNTS]
    return [(P, m) for P, m in meshes if m is not None]


class _retries(object):
    """Collects the capacities the pm's exchange retried with (from its
    log records)."""

    def __init__(self, pm):
        import logging
        self.logger = pm.logger
        self.seen = []
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.level = self.logger.level

    def _emit(self, record):
        msg = record.getMessage()
        if msg.startswith('exchange overflow'):
            self.seen.append(int(msg.rsplit('=', 1)[1]))

    def __enter__(self):
        import logging
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self.seen

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _refused(P, cat):
    """The names of the calls with no multi-rank branch yet that raise
    NotImplementedError (at P = 1 each runs, so none is tried). Each is
    built on the P-rank mesh of ``cat``."""
    if P == 1:
        return []
    calls = {'save': lambda: cat.save('unused-path'),
             'poisson': lambda: cat.rng.poisson(1.0)}
    out = []
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError:
            out.append(name)
    return sorted(out)


def _np(t):
    from nbodykit_tpu_torch.utils import as_numpy
    return as_numpy(t)


# -- programs -----------------------------------------------------------------

def exchange_cases(rank):
    """Capacities and the exchange (tests/test_torch_dist_exchange.py)."""
    import torch
    from nbodykit_tpu_torch.parallel.exchange import (auto_capacity,
                                                      counted_capacity,
                                                      exchange_by_dest)
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    T = torch.as_tensor
    out = {}
    for P, mesh in _meshes():
        r = mesh.rank
        for n in NPARTS:
            d = particles(n)
            pos, mass = rows(d['pos'], P, r), rows(d['mass'], P, r)
            dest = T(rows(d['dest'] % P, P, r))
            out['auto_capacity', n, P] = auto_capacity(dest, mesh)
            out['counted_capacity', n, P] = counted_capacity(
                mesh, T(pos * (NMESH / BOX)), n0=NMESH // P)
            pm = ParticleMesh(NMESH, BOX, dtype='f8', comm=mesh)
            for shift in (0.0, 0.5):
                out['exchange_capacity', n, shift, P] = \
                    pm.exchange_capacity(T(pos), shift=shift)
            for cap in (None, SMALL_CAPACITY):
                (rp, rm), valid, dropped = exchange_by_dest(
                    dest, [T(pos), T(mass)], mesh, cap)
                out['exchange', n, cap, P] = dict(
                    pos=_np(rp), mass=_np(rm), valid=_np(valid),
                    dropped=int(dropped))
    return out


def _paint_rows(mesh, P, cases):
    """The pm, this rank's rows and the paints of ``cases`` (method,
    window) of them."""
    import torch
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    d = particles(NPARTS[0])
    r = mesh.rank
    pos = torch.as_tensor(rows(d['pos'], P, r))
    mass = torch.as_tensor(rows(d['mass'], P, r))
    pm = ParticleMesh(NMESH, BOX, dtype='f8', comm=mesh)
    out = {}
    for method, window in cases:
        with nbodykit_tpu_torch.set_options(paint_method=method):
            out['paint', method, window, P] = _np(
                pm.paint(pos, mass, resampler=window))
    return pm, pos, mass, out


def paint_cases(rank):
    """The main path's paints, the readouts and the capacity retries of
    both (tests/test_torch_dist_paint.py: the ones held to JAX's
    multi-device paints); parallel_cases paints the other families."""
    import torch
    out = {}
    for P, mesh in _meshes():
        pm, pos, mass, got = _paint_rows(mesh, P, PAINT_AT_P)
        out.update(got)
        real = torch.as_tensor(slab(readout_field(), P, mesh.rank))
        for window in READOUT_WINDOWS:
            out['readout', window, P] = _np(pm.readout(real, pos,
                                                       resampler=window))
        for case, call in (
                ('paint_retry', lambda: pm.paint(pos, mass, capacity=4)),
                ('readout_retry',
                 lambda: pm.readout(real, pos, capacity=4))):
            with _retries(pm) as seen:
                out[case, P] = dict(value=_np(call()))
            out[case, P].update(retries=len(seen),
                                capacity=seen[-1] if seen else 4)
    return out


def parallel_cases(rank):
    """The substrate: halos, transforms, paints, readouts, draws,
    gathers, the collectives' adjoints and the refusals."""
    import torch
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.parallel import dfft
    from nbodykit_tpu_torch.parallel.halo import halo_add, halo_fill
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    from nbodykit_tpu_torch.rng import DistributedRNG
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    from nbodykit_tpu_torch.utils import (GatherArray, ScatterArray,
                                          get_data_bounds)
    T = torch.as_tensor
    out = {}
    fin = fft_inputs()
    for P, mesh in _meshes():
        r = mesh.rank
        for h in HALO_WIDTHS:
            ext, interior = halo_blocks(P, h)
            out['halo_add', h, P] = _np(halo_add(T(slab(ext, P, r)), h,
                                                 mesh))
            out['halo_fill', h, P] = _np(halo_fill(
                T(slab(interior, P, r)), h, mesh))
        x = T(slab(fin['real'], P, r))
        y = dfft.dist_rfftn(x, mesh)
        out['rfftn', P] = _np(y)
        out['irfftn', P] = _np(dfft.dist_irfftn(y, FFT_SHAPE[2], mesh))
        yc = dfft.dist_fftn_c2c(T(slab(fin['cplx'], P, r)), mesh)
        out['c2c', P] = _np(yc)
        out['ic2c', P] = _np(dfft.dist_fftn_c2c(yc, mesh, inverse=True))
        for mode in A2A_MODES:
            with nbodykit_tpu_torch.set_options(a2a_compress=mode):
                out['rfftn', mode, P] = _np(dfft.dist_rfftn(x, mesh))
        # the main path's paints are paint_cases' (one world computes them)
        pm, _, _, got = _paint_rows(mesh, P, [c for c in PAINT_CASES
                                              if c not in PAINT_AT_P])
        out.update(got)
        # rows split unevenly over the ranks, and two fields read at once
        real = T(slab(readout_field(), P, r))
        uneven = T(rows(particles(NPARTS[1])['pos'], P, r))
        out['readout_uneven', P] = _np(pm.readout(real, uneven,
                                                  resampler='cic'))
        out['readout_many', P] = [_np(v) for v in pm.readout_many(
            [real, 2 * real], uneven, resampler='tsc')]
        out['readout_one', P] = _np(pm.readout(2 * real, uneven,
                                               resampler='tsc'))
        d = particles(NPARTS[0])
        out['whitenoise', P] = _np(pm.generate_whitenoise(7))
        # a seed drawn for seed=None: each rank's numpy state differs
        from nbodykit_tpu_torch.lab import LinearMesh
        out['drawn_seed', P] = LinearMesh(power_law, BoxSize=BOX, Nmesh=8,
                                          comm=mesh).attrs['seed']
        out['particle_grid', P] = _np(
            ParticleMesh(8, BOX, comm=mesh).generate_uniform_particle_grid())
        cat = UniformCatalog(nbar=0.03, BoxSize=BOX, seed=42, comm=mesh)
        out['uniform', P] = dict(Position=_np(cat['Position']),
                                 Velocity=_np(cat['Velocity']),
                                 csize=cat.csize, Index=_np(cat['Index']))
        sl = cat.gslice(5, cat.csize - 7, 3)
        out['gslice', P] = dict(Position=_np(sl['Position']),
                                csize=sl.csize)
        out['refused', P] = _refused(P, cat)
        out['forward_refuses', P] = _forward_refusals(mesh)
        rng = DistributedRNG(11, 1001, comm=mesh)
        out['drng', P] = dict(uniform=_np(rng.uniform(itemshape=(3,))),
                              normal=_np(rng.normal(dtype='f4')),
                              choice=_np(rng.choice(7, p=np.arange(7.0)
                                                    / 21.0)))
        whole = d['pos'] if r == 0 else None
        mine = ScatterArray(whole, mesh, root=0)
        out['scatter', P] = _np(mine)
        out['gather', P] = GatherArray(mine, mesh, root=0)
        lo, hi = get_data_bounds(mine, comm=mesh)
        out['bounds', P] = (lo, hi)
        out.update(adjoint_cases(mesh, P))
    return out


# -- the collectives' adjoints, the FFT bispectrum, the forward model --------

def _dot(a, b, mesh):
    """The real inner product of two distributed tensors, summed over
    the ranks."""
    import torch
    from nbodykit_tpu_torch.parallel.runtime import global_sum
    a, b = a.detach(), b.detach()
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float(global_sum(a * b, mesh))


def _adjoint(fn, x, mesh, seed):
    """(<A x, y>, <x, A^T y>) for the linear map ``fn`` at this rank's
    ``x``, A^T y the autograd backward of a seeded ``y``."""
    import torch
    x = x.detach().clone().requires_grad_(True)
    ax = fn(x)
    rs = np.random.RandomState(seed + 100 * mesh.rank)
    yn = rs.standard_normal(tuple(ax.shape) + ((2,) if ax.is_complex()
                                               else ()))
    y = torch.as_tensor(yn, dtype=torch.float64)
    if ax.is_complex():
        y = torch.view_as_complex(y)
    y = y.to(ax.dtype)
    aty, = torch.autograd.grad(ax, x, grad_outputs=y)
    return _dot(ax, y, mesh), _dot(x, aty, mesh)


def adjoint_cases(mesh, P):
    """Each collective's backward against the dot-product identity
    <A x, y> = <x, A^T y>: both transposes (real and complex), a route
    of the exchange, halo_add and halo_fill, and the loss sum (every
    rank's gradient of a replicated sum is 1 once); the compressed
    wire refusing autograd, and ``all_reduce`` refusing it where the
    sum feeds a rank-local product (its backward would have to sum the
    ranks' cotangents, which replicated_sum's identity does not)."""
    import torch
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.parallel import dfft
    from nbodykit_tpu_torch.parallel.exchange import exchange_by_dest
    from nbodykit_tpu_torch.parallel.halo import halo_add, halo_fill
    from nbodykit_tpu_torch.parallel.runtime import global_sum
    T = torch.as_tensor
    r = mesh.rank
    out = {}
    fin = fft_inputs()
    for kind in ('real', 'cplx'):
        x = T(slab(fin[kind], P, r))
        out['adjoint', 'transpose_%s' % kind, P] = _adjoint(
            lambda v: dfft._a2a(v, mesh, 1, 0), x, mesh, 1)
        # the inverse transpose takes the (N0, N1/P, nz) layout
        y = dfft.dist_fftn_c2c(T(slab(fin['cplx'], P, r)), mesh).permute(
            1, 0, 2).contiguous()
        out['adjoint', 'inverse_transpose_%s' % kind, P] = _adjoint(
            lambda v: dfft._a2a(v, mesh, 0, 1),
            y.real if kind == 'real' else y, mesh, 2)
    d = particles(NPARTS[1])
    dest = T(rows(d['dest'] % P, P, r))
    out['adjoint', 'route', P] = _adjoint(
        lambda v: exchange_by_dest(dest, [v], mesh)[0][0],
        T(rows(d['pos'], P, r)), mesh, 3)
    for h in HALO_WIDTHS:
        ext, interior = halo_blocks(P, h)
        out['adjoint', 'halo_add_%d' % h, P] = _adjoint(
            lambda v: halo_add(v, h, mesh), T(slab(ext, P, r)), mesh, 4)
        out['adjoint', 'halo_fill_%d' % h, P] = _adjoint(
            lambda v: halo_fill(v, h, mesh), T(slab(interior, P, r)),
            mesh, 5)
    x = T(rows(d['mass'], P, r)).requires_grad_(True)
    total = global_sum(x * x, mesh)
    g, = torch.autograd.grad(total, x)
    out['adjoint', 'loss_sum', P] = (float(total.detach()),
                                     _dot(x, g, mesh) / 2)
    x = T(slab(fin['real'], P, r)).requires_grad_(True)
    with nbodykit_tpu_torch.set_options(a2a_compress='bf16'):
        try:
            dfft.dist_rfftn(x, mesh)
            refused = P == 1
        except RuntimeError:
            refused = True
    out['compressed_grad_refused', P] = refused
    x = T(slab(fin['real'], P, r)).requires_grad_(True)
    try:
        mesh.all_reduce(x.sum()) * x
        refused = False
    except RuntimeError:
        refused = True
    out['local_consumer_refused', P] = refused
    return out


# the FFT bispectrum on a catalog's f8 CIC mesh at BS_NMESH
BS_NMESH = 16
BS_NBINS = (2, 4)


def bispectrum_catalog_columns():
    return {'Position': particles(NPARTS[0])['pos']}


def bispectrum_cases(mesh, P):
    """Bispectrum(method='fft') at BS_NBINS on this rank's rows: B,
    ntri and attrs, the same on every rank."""
    from nbodykit_tpu_torch.lab import ArrayCatalog, Bispectrum
    cat = ArrayCatalog(bispectrum_catalog_columns(), BoxSize=BOX,
                       comm=mesh)
    out = {}
    for nbins in BS_NBINS:
        b = Bispectrum(cat.to_mesh(Nmesh=BS_NMESH, dtype='f8'), nbins=nbins,
                       method='fft')
        out['bispectrum', nbins, P] = dict(
            B=np.asarray(b.B['B']), ntri=np.asarray(b.B['ntri']),
            k1=np.asarray(b.B['k1']), attrs=dict(b.attrs))
    return out


# the forward model: ForwardModel(FW_NMESH, FW_NPART, BoxSize=FW_BOX, f8)
# at each (pm_steps, order) of FW_CONFIGS, on the JAX model's truth
# modes and a seeded white leaf and observation
FW_NMESH, FW_NPART, FW_BOX = 16, 512, 100.0
FW_NG = 8
FW_CONFIGS = ((1, 1), (1, 2), (2, 1), (2, 2))
FW_NOISE = 0.5
FD_EPS = 1e-6
RECOVER_STEPS, RECOVER_LR = 2, 0.05
MODES_SEED = 3


def forward_inputs(seed=13):
    """The white leaf, the observed 1 + delta, a unit direction for the
    central differences and a second observation of the linear start's
    8^3 model."""
    rs = np.random.RandomState(seed)
    d = rs.standard_normal((FW_NG,) * 3)
    return {'white': 0.3 * rs.standard_normal((FW_NG,) * 3),
            'obs': 1.0 + 0.1 * rs.standard_normal((FW_NMESH,) * 3),
            'direction': d / np.sqrt((d * d).sum()),
            'obs8': 1.0 + 0.1 * rs.standard_normal((FW_NG,) * 3)}


def forward_model(lab, steps, order, comm=None, nmesh=FW_NMESH, **kw):
    """The test configuration of either package's ForwardModel."""
    return lab(nmesh, FW_NPART, BoxSize=FW_BOX, pm_steps=steps, order=order,
               dtype='f8', comm=comm, **kw)


def forward_cases(mesh, P, modes_np):
    """Per config: the density of the truth modes, the loss's value and
    gradient at the white leaf; at (2, 2) the central differences along
    a direction; at (1, 2) two Adam steps of recover. Fields and
    gradients are this rank's slabs, the rest the same on every rank."""
    import torch
    from nbodykit_tpu_torch import convert
    from nbodykit_tpu_torch import forward as F
    from nbodykit_tpu_torch.parallel.runtime import global_sum
    T = torch.as_tensor
    inp = forward_inputs()
    out = {}
    for steps, order in FW_CONFIGS:
        m = forward_model(F.ForwardModel, steps, order, mesh)
        modes = convert.modes_from_numpy(modes_np, m)
        with torch.no_grad():
            dens = m.density(modes)
        obs = T(slab(inp['obs'], P, mesh.rank))
        loss = F.make_loss(m, obs, noise_std=FW_NOISE)
        w = convert.white_from_numpy(inp['white'], m).requires_grad_(True)
        val = loss(w)
        g, = torch.autograd.grad(val, w)
        rec = dict(density=_np(dens), value=float(val), grad=_np(g))
        if (steps, order) == (2, 2):
            d = convert.white_from_numpy(inp['direction'], m)
            with torch.no_grad():
                hi = float(loss(w.detach() + FD_EPS * d))
                lo = float(loss(w.detach() - FD_EPS * d))
            rec['fd'] = (hi - lo) / (2 * FD_EPS)
            rec['grad_dot'] = float(global_sum(g * d, mesh))
        if (steps, order) == (1, 2):
            wr, losses = F.recover(m, obs, steps=RECOVER_STEPS,
                                   lr=RECOVER_LR, noise_std=FW_NOISE)
            rec['recover'] = dict(white=_np(wr), losses=losses)
        out['forward', steps, order, P] = rec
    return out


def inference_cases(mesh, P, modes_np):
    """The inference metrics of the (1, 2) model on the truth modes and
    the white leaf's, its FFTRecon baseline, and the linear start on an
    8^3 model."""
    import torch
    from nbodykit_tpu_torch import convert
    from nbodykit_tpu_torch import forward as F
    T = torch.as_tensor
    inp = forward_inputs()
    m = forward_model(F.ForwardModel, 1, 2, mesh)
    modes = convert.modes_from_numpy(modes_np, m)
    lat = m.lattice
    with torch.no_grad():
        b = m.modes_from_white(convert.white_from_numpy(inp['white'], m))
        rec = dict(
            binned_power=[_np(v) for v in F.binned_power(lat, modes)],
            cross_correlation=[_np(v) for v in F.cross_correlation(
                lat, modes, b)],
            mean_cross_correlation=[float(F.mean_cross_correlation(
                lat, modes, b, kmax)) for kmax in (None, 0.2)])
        pos, _ = m.evolve(modes)
        rec['baseline'] = _np(F.fftrecon_baseline(m, pos))
    m8 = forward_model(F.ForwardModel, 1, 2, mesh, nmesh=FW_NG)
    rec['linear_init'] = _np(F.linear_init(
        m8, T(slab(inp['obs8'], P, mesh.rank))))
    return {('inference', P): rec}


def _forward_refusals(mesh):
    """Whether ForwardModel refuses, with a ValueError naming the rule,
    an ng (3 at npart 27) and an nmesh (6) not divisible by the rank
    count (the nmesh one only where 6 is not divisible)."""
    from nbodykit_tpu_torch.forward import ForwardModel
    refused = []
    for nmesh, npart in ((FW_NMESH, 3 ** 3), (6, 4 ** 3)):
        try:
            ForwardModel(nmesh, npart, comm=mesh, dtype='f8')
        except ValueError as e:
            refused.append('divisible by the rank count' in str(e))
    return refused


def forward_program(rank, modes_path):
    """The forward model's value, gradient and Adam steps across ranks
    (tests/test_torch_dist_forward.py); the JAX model's truth modes at
    ``modes_path`` (an .npy file)."""
    out = {}
    modes = np.load(modes_path)
    for P, mesh in _meshes():
        out.update(forward_cases(mesh, P, modes))
    return out


def inference_program(rank, modes_path):
    """The FFT bispectrum, the inference metrics, the FFTRecon baseline
    and the linear start across ranks
    (tests/test_torch_dist_inference.py)."""
    out = {}
    modes = np.load(modes_path)
    for P, mesh in _meshes():
        out.update(bispectrum_cases(mesh, P))
        out.update(inference_cases(mesh, P, modes))
    return out


# the FFT algorithms on a UniformCatalog (test_torch_dist_fftpower.py)
CAT_BOX = 100.0
CAT_NBAR = 3e-3
FFT_NMESH = 32
FFT_CASES = ('power_2d', 'power_interlaced_tsc_mxu', 'power_dk0',
             'corr_2d', 'projected_01', 'projected_2', 'power_1d',
             'power_bf16', 'power_int16')


def fft_case(lab, cat, case, mesh_kw=None):
    """Run FFT algorithm case ``case`` of ``lab`` (either package's) on
    ``cat``; returns {name: numpy column} of its BinnedStatistics and
    the shot noise."""
    set_options = lab['set_options']
    out = {}
    opts = {}
    if case in ('power_bf16', 'power_int16'):
        opts['a2a_compress'] = case.split('_')[1]
    if case == 'power_interlaced_tsc_mxu':
        opts['paint_method'] = 'mxu'
    with set_options(**opts):
        if case == 'power_2d':
            r = lab['FFTPower'](cat, mode='2d', Nmesh=FFT_NMESH, Nmu=5,
                                poles=[0, 2, 4])
            stats = {'power': r.power, 'poles': r.poles}
        elif case == 'power_interlaced_tsc_mxu':
            mesh = cat.to_mesh(Nmesh=FFT_NMESH, resampler='tsc',
                               interlaced=True, compensated=True,
                               dtype='f8')
            r = lab['FFTPower'](mesh, mode='1d')
            stats = {'power': r.power}
        elif case == 'power_dk0':
            r = lab['FFTPower'](cat, mode='1d', Nmesh=FFT_NMESH, dk=0)
            stats = {'power': r.power}
        elif case == 'corr_2d':
            r = lab['FFTCorr'](cat, mode='2d', Nmesh=FFT_NMESH, Nmu=4,
                               poles=[0, 2])
            stats = {'power': r.corr, 'poles': r.poles}
        elif case.startswith('projected'):
            axes = [int(c) for c in case.split('_')[1]]
            r = lab['ProjectedFFTPower'](cat, Nmesh=FFT_NMESH, axes=axes)
            stats = {'power': r.power}
        else:
            r = lab['FFTPower'](cat, mode='1d', Nmesh=FFT_NMESH)
            stats = {'power': r.power}
    for name, stat in stats.items():
        for col in stat.variables:
            out[name, col] = np.asarray(stat[col])
    out['shotnoise'] = r.attrs.get('shotnoise')
    return out


def fftpower_cases(rank):
    """The FFT algorithms across ranks: every rank's result at each rank
    count (tests/test_torch_dist_fftpower.py)."""
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.lab import (FFTCorr, FFTPower,
                                        ProjectedFFTPower, UniformCatalog)
    lab = dict(set_options=nbodykit_tpu_torch.set_options,
               FFTPower=FFTPower, FFTCorr=FFTCorr,
               ProjectedFFTPower=ProjectedFFTPower)
    out = {}
    for P, mesh in _meshes():
        cat = UniformCatalog(nbar=CAT_NBAR, BoxSize=CAT_BOX, seed=42,
                             comm=mesh)
        for case in FFT_CASES:
            out[case, P] = fft_case(lab, cat, case)
    return out


def survey_cases(rank):
    """The mesh algorithms and sources of SV_CASES across ranks
    (tests/test_torch_dist_survey.py)."""
    out = {}
    survey_lab = port_lab()
    for P, mesh in _meshes():
        for case in SV_CASES:
            t0 = time.perf_counter()
            out[case, P] = survey_case(survey_lab, case, mesh)
            out[case, P]['seconds'] = time.perf_counter() - t0
    return out


# the mesh algorithms and mesh sources on the slab path
# (test_torch_dist_survey.py): surveys through ConvolvedFFTPower, BAO
# reconstruction, n(z), ArrayMesh, LinearMesh and the species mesh
SV_NMESH = 16
SV_BOX = 200.0
SV_NBAR = 2001 / 300.0 ** 3
SV_CASES = ('cp_even', 'cp_odd', 'cp_cross', 'cp_sparse', 'recon_LGS',
            'recon_LRR', 'recon_LF2', 'zhist_auto', 'zhist_int',
            'arraymesh', 'linearmesh', 'species')
# the corners of the surveys' extent: a randoms catalog of 5 rows leaves
# the last of 4 ranks with none
SPARSE_RANDOMS = [[95.0, 95.0, 95.0], [410.0, 410.0, 410.0],
                  [95.0, 410.0, 250.0], [410.0, 95.0, 250.0],
                  [250.0, 250.0, 95.0]]


def survey(seed=1, nd=2001, nr=6003):
    """Data and randoms of a survey: weights, selections and an n(z)
    column that varies, its randoms mean scaled to the data's."""
    rng = np.random.RandomState(seed)
    data = {'Position': rng.uniform(100, 400, (nd, 3)),
            'NZ': SV_NBAR * rng.uniform(0.8, 1.2, nd),
            'Weight': rng.uniform(0.5, 1.5, nd),
            'Selection': rng.uniform(size=nd) > 0.1}
    randoms = {'Position': rng.uniform(95, 410, (nr, 3)),
               'NZ': SV_NBAR * rng.uniform(0.8, 1.2, nr),
               'Selection': rng.uniform(size=nr) > 0.05}
    randoms['NZ'] *= data['NZ'].mean() / randoms['NZ'].mean()
    return data, randoms


def sparse_survey():
    """The survey's data with a constant n(z) and 5 randoms at the
    corners of its extent: with unit FKP weights both normalizations
    are nbar times the selected data weight."""
    data, _ = survey()
    data['NZ'] = np.full(len(data['NZ']), SV_NBAR)
    randoms = {'Position': np.array(SPARSE_RANDOMS),
               'NZ': np.full(len(SPARSE_RANDOMS), SV_NBAR)}
    return data, randoms


def recon_catalogs(seed=3, nd=2001, nr=6003):
    """Clustered data and uniform randoms in SV_BOX, f8."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, SV_BOX, (30, 3))
    data = np.mod(centres[rng.randint(30, size=nd)]
                  + rng.normal(scale=12.0, size=(nd, 3)), SV_BOX)
    return data, rng.uniform(0, SV_BOX, (nr, 3))


def power_law(k):
    """A linear power spectrum for LinearMesh, on either package's
    arrays."""
    return 1e4 * (k + 0.05) ** -2


def survey_case(lab, case, comm=None):
    """Run case ``case`` of SV_CASES with ``lab`` (either package's
    names) on catalogs of ``comm``; returns {name: numpy value}. Fields
    are this rank's slab; everything else is the same on every rank."""
    as_numpy = lab['as_numpy']

    def cat(cols, **kw):
        return lab['ArrayCatalog'](cols, comm=comm, **kw)

    def power(mesh):
        p = lab['FFTPower'](mesh, mode='1d').power
        return {c: as_numpy(p[c]) for c in ('k', 'power', 'modes')}

    out = {}
    if case.startswith('cp_'):
        data, randoms = sparse_survey() if case == 'cp_sparse' else \
            survey()
        fkp = lab['FKPCatalog'](cat(data), cat(randoms),
                                P0=None if case == 'cp_sparse' else 1e4)
        mesh = fkp.to_mesh(Nmesh=SV_NMESH, resampler='cic' if
                           case == 'cp_odd' else 'tsc')
        kw = dict(poles=[0, 2, 4], dk=0.05)
        if case == 'cp_odd':
            kw['poles'] = [0, 1, 2]
        elif case == 'cp_cross':
            kw.update(poles=[0, 2], second=fkp.to_mesh(Nmesh=SV_NMESH,
                                                        resampler='cic'))
        r = lab['ConvolvedFFTPower'](mesh, **kw)
        out.update({c: as_numpy(r.poles[c]) for c in r.poles.variables})
        for key in ('alpha', 'data.norm', 'randoms.norm', 'shotnoise',
                    'data.W', 'randoms.W', 'data.N', 'randoms.N'):
            out[key] = float(r.attrs[key])
        out['BoxSize'] = np.asarray(mesh.attrs['BoxSize'])
        out['BoxCenter'] = np.asarray(mesh.attrs['BoxCenter'])
    elif case.startswith('recon_'):
        scheme = case.split('_')[1]
        data, ran = recon_catalogs()
        r = lab['FFTRecon'](cat({'Position': data}, BoxSize=SV_BOX),
                            cat({'Position': ran}, BoxSize=SV_BOX),
                            Nmesh=SV_NMESH, bias=2.0, f=0.77, R=15,
                            scheme=scheme, revert_rsd_random=scheme == 'LRR')
        field = r.compute()
        out['field'] = as_numpy(field.value)
        out.update(power(lab['FieldMesh'](field)))
    elif case.startswith('zhist_'):
        rng = np.random.RandomState(7)
        z = rng.uniform(0.1, 1.0, 4001) ** 1.3
        w = rng.uniform(0.5, 1.5, 4001)
        h = lab['RedshiftHistogram'](
            cat({'Redshift': z, 'W': w}), 0.1, lab['Planck15'],
            bins=None if case == 'zhist_auto' else 10, weight='W')
        out.update(bin_edges=np.asarray(h.bin_edges), nbar=h.nbar,
                   counts=np.asarray(h.hist['counts']), dV=h.dV)
    elif case == 'arraymesh':
        arr = np.random.RandomState(9).standard_normal((SV_NMESH,) * 3)
        mesh = lab['ArrayMesh'](arr, SV_BOX, comm=comm)
        out['rows'] = int(mesh.compute().value.shape[0])
        out.update(power(mesh))
        out['preview_x'] = mesh.preview(axes=[0])
        out['preview_yz'] = mesh.preview(axes=[1, 2])
    elif case == 'linearmesh':
        mesh = lab['LinearMesh'](power_law, BoxSize=SV_BOX, Nmesh=SV_NMESH,
                                 seed=42, dtype='f8', comm=comm)
        out['rows'] = int(mesh.compute().value.shape[0])
        out.update(power(mesh))
    elif case == 'species':
        rng = np.random.RandomState(11)
        a = {'Position': rng.uniform(0, SV_BOX, (2001, 3)),
             'Weight': rng.uniform(0.5, 1.5, 2001)}
        b = {'Position': rng.uniform(0, SV_BOX, (1503, 3))}
        both = lab['MultipleSpeciesCatalog'](['a', 'b'], cat(a), cat(b))
        out['csize'] = both.csize
        out['size'] = len(both)
        field = both.to_mesh(Nmesh=SV_NMESH, BoxSize=SV_BOX,
                             dtype='f8').to_real_field()
        out['field'] = as_numpy(field.value)
        for key in ('N', 'W', 'num_per_cell'):
            out[key] = float(field.attrs[key])
    else:
        raise ValueError(case)
    return out


def port_lab():
    """The port's names that survey_case takes."""
    from nbodykit_tpu_torch import lab
    from nbodykit_tpu_torch.utils import as_numpy
    names = ('ArrayCatalog', 'ArrayMesh', 'ConvolvedFFTPower',
             'FFTPower', 'FFTRecon', 'FieldMesh', 'FKPCatalog',
             'LinearMesh', 'MultipleSpeciesCatalog', 'Planck15',
             'RedshiftHistogram')
    out = {n: getattr(lab, n) for n in names}
    out['as_numpy'] = as_numpy
    return out



# -- the particle algorithms across ranks (test_torch_dist_particles.py) ------

PT_LL = 0.6             # FOF's linking length (absolute): a slab at P = 4
PT_NMIN = 5
PT_RMAX = 2.0           # the routes' ghost band
PT_EDGES = np.linspace(0.5, 6.0, 7)
PT_NMU = 4
PT_PIMAX = 5.0
PT_SIZE = 1001          # the scatter and gather table's entries
PT_SPARSE = 40          # a sparse catalog: FOF and KDDensity past a slab
PT_LL_WIDE = 13.0       # wider than a slab at P = 4 (12.5), not at P = 2
PT_WIDE_EDGES = np.linspace(1.0, 13.0, 4)
PT_KDD_MARGIN = 1.0
PT_NCROSS = 5000
PT_NRANDOMS = 1500      # the 2PCFs' randoms
PT_SURVEY_OFFSET = 300.0
PT_MASS = 1e12
PT_SKY = dict(ra=(10.0, 13.0), dec=(-1.5, 1.5), z=(0.40, 0.42))


def clustered(n, seed=3):
    """A catalog's columns: n positions in [0, BOX), half in 40 blobs of
    width 0.4 and half uniform; velocities, weights, and columns with
    ties (an integer Key, a float Score with -0.0, a Density)."""
    rs = np.random.RandomState(seed)
    centers = rs.uniform(0, BOX, (40, 3))
    half = n // 2
    pts = centers[rs.randint(0, 40, half)] + rs.normal(0, 0.4, (half, 3))
    score = rs.randint(-20, 20, n) * 0.5
    score[rs.rand(n) < 0.05] = -0.0
    return {'Position': np.concatenate([pts % BOX,
                                        rs.uniform(0, BOX, (n - half, 3))]),
            'Velocity': rs.normal(0, 1, (n, 3)),
            'Weight': rs.uniform(0.5, 1.5, n),
            'Density': rs.randint(0, 8, n).astype('f8'),
            'Key': rs.randint(0, 30, n).astype('i8'),
            'Score': score}


def scatter_inputs(n, seed=11):
    rs = np.random.RandomState(seed + n)
    return {'idx': rs.randint(0, PT_SIZE, n),
            'int': rs.randint(-1000, 1000, n),
            'float': rs.standard_normal(n),
            'valid': rs.rand(n) < 0.8,
            'table': np.arange(PT_SIZE * 3, dtype='f8').reshape(PT_SIZE, 3)
            * 7.0}


def sky(n, seed=17):
    """(RA, DEC, Redshift, Weight) of a small patch of sky."""
    rs = np.random.RandomState(seed + n)
    return {k: rs.uniform(lo, hi, n) for k, (lo, hi) in
            (('RA', PT_SKY['ra']), ('DEC', PT_SKY['dec']),
             ('Redshift', PT_SKY['z']), ('Weight', (0.5, 1.5)))}


def pair_inputs(n):
    """The pair counts' inputs: (case, pos1, w1, pos2, w2, box, kw) with
    the keywords of ``paircount`` / ``paircount_dist``."""
    d = clustered(n)
    box = np.full(3, BOX)
    cases = [(mode, d['Position'], d['Weight'], d['Position'], d['Weight'],
              box, dict(mode=mode, periodic=True, is_auto=True, **kw))
             for mode, kw in (('1d', {}), ('2d', dict(Nmu=PT_NMU)),
                              ('projected', dict(pimax=PT_PIMAX)))]
    other = clustered(PT_NCROSS, seed=5)['Position']
    cases.append(('cross', d['Position'], None, other, None, box,
                  dict(mode='1d', periodic=False, is_auto=False)))
    far = d['Position'] + PT_SURVEY_OFFSET
    lo, hi = far.min(axis=0), far.max(axis=0)
    cases.append(('survey', far, d['Weight'], far, d['Weight'],
                  (hi - lo) * 1.001 + 1e-3,
                  dict(mode='2d', Nmu=PT_NMU, periodic=False, is_auto=True,
                       grid_origin=lo, pair_los='midpoint')))
    return cases


def sparse_columns():
    return {'Position': particles(PT_SPARSE, seed=21)['pos']}


def _catalog_columns(cat, names):
    return {c: _np(cat[c]) for c in names}


def particle_cases(rank):
    """The slab routes, the table reduce and lookup, the sorts, FOF with
    its halos, the pair counts with the 2PCFs and KDDensity on this
    rank's rows at every P."""
    import torch
    from nbodykit_tpu_torch.lab import (ArrayCatalog, FOF, KDDensity,
                                        Planck15, SimulationBoxPairCount)
    from nbodykit_tpu_torch.algorithms.pair_counters.core import \
        paircount_dist
    from nbodykit_tpu_torch.parallel.domain import (
        balanced_slab_edges, gather_by_index, scatter_reduce_by_index,
        slab_route)
    from nbodykit_tpu_torch.parallel.runtime import row_range
    from nbodykit_tpu_torch.parallel.sort import dist_sort, sortable_key
    T = torch.as_tensor
    out = {}
    for P, mesh in _meshes():
        r = mesh.rank
        for n in NPARTS:
            d = clustered(n)
            start, _ = row_range(n, P, r)
            pos = T(rows(d['Position'], P, r))
            gid = start + torch.arange(pos.shape[0])
            out['edges', n, P] = balanced_slab_edges(pos[:, 0], BOX, P,
                                                     PT_LL, mesh=mesh)
            for ghosts, periodic in (('down', True), ('both', True),
                                     ('both', False), (None, True)):
                route, f, live = slab_route(pos, BOX, PT_RMAX, mesh,
                                            ghosts=ghosts, periodic=periodic,
                                            balance=True)
                (g1,), ok, dropped = route.exchange([gid])
                (g2,), ok2, _ = route.exchange([torch.cat([gid * 2] * f)])
                out['route', n, ghosts, periodic, P] = dict(
                    gid=_np(g1[ok]), f=f, edges=route.edges,
                    dropped=int(dropped), live=int(live.sum()),
                    aligned=bool(torch.equal(ok, ok2)
                                 and torch.equal(g2[ok], g1[ok] * 2)))
            s = scatter_inputs(n)
            idx, valid = T(rows(s['idx'], P, r)), T(rows(s['valid'], P, r))
            for kind in ('int', 'float'):
                vals = T(rows(s[kind], P, r))
                for op in ('add', 'min', 'max'):
                    out['scatter', n, kind, op, P] = _np(
                        scatter_reduce_by_index(
                            idx, vals, PT_SIZE, mesh, op=op,
                            valid=valid if kind == 'float' else None))
            out['gather', n, P] = _np(gather_by_index(
                idx, T(rows(s['table'], P, r)), mesh))
            for col in ('Key', 'Score'):
                keys, perm = dist_sort(sortable_key(T(rows(d[col], P, r))),
                                       gid, mesh)
                out['dist_sort', n, col, P] = dict(keys=_np(keys),
                                                   perm=_np(perm))
            cat = ArrayCatalog(d, BoxSize=BOX, comm=mesh)
            for case, args in (('multi', (['Key', 'Score'],)),
                               ('reverse', ('Key', True)),
                               ('float', ('Score',))):
                out['sort', n, case, P] = _catalog_columns(
                    cat.sort(*args), ('Key', 'Score', 'Position'))
            for periodic in (True, False):
                fof = FOF(cat, PT_LL, PT_NMIN, absolute=True,
                          periodic=periodic)
                feats = fof.find_features(peakcolumn='Density')
                halos = fof.to_halos(PT_MASS, Planck15, 0.0)
                out['fof', n, periodic, P] = dict(
                    labels=_np(fof.labels), nhalo=fof._halo_count,
                    branch=fof.branch, features=_catalog_columns(
                        feats, ('Length', 'CMPosition', 'CMVelocity',
                                'PeakPosition', 'PeakVelocity')),
                    halos=_catalog_columns(halos, ('Position', 'Velocity',
                                                   'Mass', 'Radius')),
                    halo_csize=halos.csize)
            kd = KDDensity(cat, margin=PT_KDD_MARGIN)
            vol = 4.0 / 3 * np.pi * kd.attrs['kernel_radius'] ** 3
            out['kdd', n, P] = dict(counts=_np(kd.density) * vol,
                                    branch=kd.branch)
            for case, p1, w1, p2, w2, box, kw in pair_inputs(n):
                args = [None if a is None else T(rows(a, P, r))
                        for a in (p1, w1, p2, w2)]
                out['pairs', n, case, P] = paircount_dist(
                    *args, box, PT_EDGES, mesh, **kw)
        out['classes', P] = _pair_classes(clustered(NPARTS[1]), mesh)
        sparse = ArrayCatalog(sparse_columns(), BoxSize=BOX, comm=mesh)
        out['box_wide', P] = _pair_record(
            SimulationBoxPairCount('1d', sparse, PT_WIDE_EDGES),
            PAIR_TOTALS)
        fof = FOF(sparse, PT_LL_WIDE, 2, absolute=True)
        out['fof_wide', P] = dict(labels=_np(fof.labels), branch=fof.branch,
                                  nhalo=fof._halo_count)
        # the kernel radius PT_LL_WIDE, in mean separations
        kd = KDDensity(sparse, margin=PT_LL_WIDE * PT_SPARSE ** (1 / 3.)
                       / BOX)
        out['kdd_wide', P] = dict(density=_np(kd.density), branch=kd.branch)
    return out


PAIR_TOTALS = ('total_wnpairs', 'W1', 'W2', 'N1', 'N2')


def _pair_record(pc, keys=PAIR_TOTALS):
    return dict(npairs=np.asarray(pc.pairs['npairs']),
                wnpairs=np.asarray(pc.pairs['wnpairs']), branch=pc.branch,
                **{k: pc.attrs[k] for k in keys})


def _pair_classes(d, mesh):
    """The pair-count classes and 2PCFs on this rank's rows: results,
    totals and branches (the same on every rank)."""
    from nbodykit_tpu_torch.lab import (ArrayCatalog, Planck15,
                                        SimulationBox2PCF,
                                        SimulationBoxPairCount,
                                        SurveyData2PCF)
    n = len(d['Weight'])
    cat = ArrayCatalog(d, BoxSize=BOX, comm=mesh)
    randoms = ArrayCatalog(
        {'Position': particles(PT_NRANDOMS, seed=23)['pos']}, BoxSize=BOX,
        comm=mesh)
    out = {'box': _pair_record(SimulationBoxPairCount('1d', cat, PT_EDGES)),
           'box_cross': _pair_record(SimulationBoxPairCount(
               '2d', cat, PT_EDGES, second=randoms, Nmu=PT_NMU))}
    out['natural'] = np.asarray(
        SimulationBox2PCF('1d', cat, PT_EDGES).corr['corr'])
    out['landy_szalay'] = np.asarray(SimulationBox2PCF(
        '1d', cat, PT_EDGES, randoms1=randoms).corr['corr'])
    xi = SurveyData2PCF('2d', ArrayCatalog(sky(n), comm=mesh),
                        ArrayCatalog(sky(n, seed=19), comm=mesh), PT_EDGES,
                        cosmo=Planck15, Nmu=PT_NMU)
    out['survey'] = dict(corr=np.asarray(xi.corr['corr']), **{
        name: _pair_record(pc) for name, pc in
        (('DD', xi.D1D2), ('DR', xi.D1R2), ('RR', xi.R1R2))})
    return out


# -- the 3PCF, CGM, FiberCollisions, the direct bispectrum and populate
# across ranks (test_torch_dist_groups.py) ---------------------------------

GR_3PT_EDGES = np.linspace(0.5, 4.0, 5)
GR_SKY_EDGES = np.linspace(1.0, 8.0, 5)   # a slab of the sky's box at P = 4
GR_POLES = [0, 1, 2]
GR_CYL = (1.0, 2.0)                       # rperp, rpar
GR_CYL_WIDE = (5.0, 12.0)                 # sqrt(rperp^2 + rpar^2) = 13
GR_RANKBY = ['Key', 'Score']              # ties in both columns
GR_FIBER_RADIUS = 120. / 3600.            # degrees: pairs and multiplets
GR_FIBER_SEED = 42
GR_BS_NBINS = 3
GR_HOD_SEED = 11
GR_HOD_MODELS = ('Zheng07Model', 'Hearin15Model')
GR_REDSHIFT = 0.5
# the catalog size each costlier case runs at (the world's time)
GR_AT = {'3pcf': NPARTS[1], '3pcf_survey': NPARTS[0], 'cgm': NPARTS[0],
         'cgm_open': NPARTS[1],
         'populate': {NPARTS[0]: 'Zheng07Model', NPARTS[1]: 'Hearin15Model'}}


def halo_columns(n, seed=29):
    """Halos in [0, BOX): Mass log-uniform in [10^12.5, 10^15], and a
    Concentration column of their own."""
    rs = np.random.RandomState(seed + n)
    return {'Position': rs.uniform(0, BOX, (n, 3)),
            'Velocity': rs.normal(0, 300.0, (n, 3)),
            'Mass': 10 ** rs.uniform(12.5, 15.0, n),
            'Concentration': rs.uniform(3.0, 12.0, n)}


def halos_of(lab, cols, comm=None):
    """The HaloCatalog of ``cols`` with their own Concentration, in
    either package (``lab`` its names)."""
    kw = {} if comm is None else dict(comm=comm)
    halos = lab['HaloCatalog'](lab['ArrayCatalog'](
        {k: v for k, v in cols.items() if k != 'Concentration'}, BoxSize=BOX,
        **kw), lab['Planck15'], GR_REDSHIFT)
    halos['Concentration'] = cols['Concentration']
    return halos


def _three_pt(pc):
    return dict(branch=getattr(pc, 'branch', None),
                **{'corr_%d' % ell: np.asarray(pc.poles['corr_%d' % ell])
                   for ell in GR_POLES})


def _groups(cgm):
    return dict(rounds=cgm.rounds, branch=cgm.branch,
                **_catalog_columns(cgm.groups, ('cgm_type', 'cgm_haloid',
                                                'num_cgm_sats')))


def group_cases(rank):
    """The 3PCF (box and survey; slab and gathered), CylindricalGroups
    (periodic and open, ties in ``rankby``; slab and gathered),
    FiberCollisions, ``pairblock_sum`` with the direct bispectrum and
    HOD population, on this rank's rows at every P. The costlier cases
    take one catalog size each (GR_AT)."""
    import torch
    from nbodykit_tpu_torch import hod, lab
    from nbodykit_tpu_torch.algorithms.bispectrum import (direct_bispectrum,
                                                          shell_modes)
    from nbodykit_tpu_torch.ops.pairblock import lattice_kvecs, pairblock_sum
    T = torch.as_tensor
    port = dict(HaloCatalog=lab.HaloCatalog, ArrayCatalog=lab.ArrayCatalog,
                Planck15=lab.Planck15)
    out = {}
    for P, mesh in _meshes():
        r = mesh.rank
        for n in NPARTS:
            d = clustered(n)
            cat = lab.ArrayCatalog(d, BoxSize=BOX, comm=mesh)
            dsky = lab.ArrayCatalog(sky(n), comm=mesh)
            if n == GR_AT['3pcf']:
                out['3pcf', n, P] = _three_pt(lab.SimulationBox3PCF(
                    cat, GR_POLES, GR_3PT_EDGES))
            if n == GR_AT['3pcf_survey']:
                out['3pcf_survey', n, P] = _three_pt(lab.SurveyData3PCF(
                    dsky, GR_POLES, GR_SKY_EDGES, lab.Planck15))
            if n == GR_AT['cgm']:
                out['cgm', n, P] = _groups(lab.CylindricalGroups(
                    cat, GR_RANKBY, *GR_CYL))
            if n == GR_AT['cgm_open']:
                nobox = lab.ArrayCatalog(d, comm=mesh)
                out['cgm_open', n, P] = _groups(lab.CylindricalGroups(
                    nobox, GR_RANKBY, *GR_CYL, periodic=False))
            fc = lab.FiberCollisions(dsky['RA'], dsky['DEC'],
                                     collision_radius=GR_FIBER_RADIUS,
                                     seed=GR_FIBER_SEED, comm=mesh)
            out['fiber', n, P] = _catalog_columns(
                fc.labels, ('Label', 'Collided', 'NeighborID'))
            q, _ = shell_modes(GR_BS_NBINS)
            pos, w = T(rows(d['Position'], P, r)), T(rows(d['Weight'], P, r))
            out['pairblock', n, P] = _np(pairblock_sum(
                pos, w, lattice_kvecs(q, BOX), comm=mesh))
            B, ntri = direct_bispectrum(pos, w, BOX, GR_BS_NBINS, comm=mesh)
            bs = lab.Bispectrum(cat, nbins=GR_BS_NBINS, method='direct')
            out['direct_bs', n, P] = dict(
                B=B, ntri=ntri, cls_B=np.asarray(bs.B['B']),
                cls_ntri=np.asarray(bs.B['ntri']),
                comm_kept=bs.comm is cat.comm)
            name = GR_AT['populate'][n]
            halos = halos_of(port, halo_columns(n), comm=mesh)
            gal = halos.populate(getattr(hod, name), seed=GR_HOD_SEED)
            out['populate', n, name, P] = dict(
                comm_kept=gal.comm is halos.comm, csize=gal.csize,
                seed=gal.attrs['seed'], **_catalog_columns(
                    gal, ('Position', 'Velocity', 'gal_type', 'HaloMass')))
        # seeds drawn for seed=None: rank 0's on every rank
        few = halos_of(port, halo_columns(PT_SPARSE), comm=mesh)
        out['seeds', P] = dict(
            populate=hod.HODModel(hod.Zheng07Model()).populate(
                few).attrs['seed'],
            fiber=lab.FiberCollisions(sky(PT_SPARSE)['RA'],
                                      sky(PT_SPARSE)['DEC'],
                                      comm=mesh).attrs['seed'])
        sparse = lab.ArrayCatalog(sparse_columns(), BoxSize=BOX, comm=mesh)
        out['3pcf_wide', P] = _three_pt(lab.SimulationBox3PCF(
            sparse, GR_POLES, PT_WIDE_EDGES))
        out['3pcf_survey_wide', P] = _three_pt(lab.SurveyData3PCF(
            lab.ArrayCatalog(sky(PT_SPARSE), comm=mesh), GR_POLES,
            PT_WIDE_EDGES, lab.Planck15))
        out['cgm_wide', P] = _groups(lab.CylindricalGroups(
            sparse, None, *GR_CYL_WIDE))
    return out


# -- TaskManager across ranks (test_torch_dist_batch.py) ----------------------

BT_TASKS = 7
BT_CPUS = (1, 2, 3, 4)
BT_RAISING = (3, 4)          # on groups 1 and 0 of two: task 3 is first
BT_SEEDS = (5, 6, 7, 8)
BT_NBAR, BT_BOX, BT_NMESH = 2e-3, 60.0, 16


def _task_record(task):
    """Who ran ``task``: the ambient mesh's world ranks and size, and an
    all_reduce over it (every rank of the group adds 1)."""
    import torch
    from nbodykit_tpu_torch.parallel.runtime import CurrentMesh, mesh_size
    mesh = CurrentMesh.get()
    total = mesh.all_reduce(torch.ones(1)) if mesh_size(mesh) > 1 else \
        torch.ones(1)
    return dict(task=task, ranks=list(mesh.ranks), total=float(total))


def _maybe_raise(task):
    if task in BT_RAISING:
        raise ValueError("task %d failed" % task)
    return _task_record(task)


def _power_task(seed):
    """FFTPower of a seeded UniformCatalog on the ambient mesh (f8)."""
    from nbodykit_tpu_torch.lab import FFTPower, UniformCatalog
    cat = UniformCatalog(nbar=BT_NBAR, BoxSize=BT_BOX, seed=seed)
    r = FFTPower(cat.to_mesh(Nmesh=BT_NMESH, dtype='f8'), mode='1d')
    return dict(power=np.asarray(r.power['power'].real),
                modes=np.asarray(r.power['modes']), nrank=cat.comm.size
                if cat.comm is not None else 1)


def batch_cases(rank):
    """TaskManager on the world of 4 ranks: map, iterate, sub_meshes and
    the ambient mesh at every ``cpus_per_task`` of BT_CPUS; a raising
    task; ``use_all_cpus``; FFTPower tasks on groups of 2 against the
    serial one-rank map."""
    from nbodykit_tpu_torch.batch import TaskManager
    from nbodykit_tpu_torch.parallel.runtime import CurrentMesh, cpu_mesh
    world = cpu_mesh(WORLD)
    out = {}
    for cpus in BT_CPUS:
        with TaskManager(cpus, comm=world) as tm:
            amb = CurrentMesh.get()
            out['ambient', cpus] = list(amb.ranks)
            out['map', cpus] = tm.map(_task_record, range(BT_TASKS))
            out['iterate', cpus] = list(tm.iterate(range(BT_TASKS)))
            out['sub_meshes', cpus] = [
                None if m is None else list(m.ranks)
                for m in tm.sub_meshes()]
        out['after', cpus] = CurrentMesh.get() is None
    with TaskManager(2, comm=world) as tm:
        try:
            tm.map(_maybe_raise, range(BT_TASKS))
            out['raised'] = None
        except ValueError as e:
            out['raised'] = dict(message=str(e), task_index=e.task_index,
                                 remote=getattr(e, 'remote_traceback',
                                                None) is not None)
        out['after_raise'] = tm.map(_task_record, range(2))
    with TaskManager(1, comm=world, use_all_cpus=True) as tm:
        out['all_cpus'] = tm.map(_task_record, range(3))
        out['all_cpus_meshes'] = len(tm.sub_meshes())
        out['is_root'] = tm.is_root()
        with tm.everyone():
            out['everyone'] = True
    with TaskManager(2, comm=world) as tm:
        out['power'] = tm.map(_power_task, BT_SEEDS)
    tm = TaskManager(2)
    out['serial_meshes'] = tm.sub_meshes()
    out['serial_iterate'] = list(tm.iterate(range(3)))
    out['serial_power'] = tm.map(_power_task, BT_SEEDS)
    return out
