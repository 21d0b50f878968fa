"""Rank programs of the multi-rank CPU tests of the torch port.

``run_world(program, nprocs)`` spawns ``nprocs`` processes (the
``spawn`` start method), joins them into a gloo world through a file in
a temporary directory (no fixed port, so concurrent test workers do not
collide), runs ``program(rank)`` on each with one torch thread and the
port on the CPU, and returns each rank's result. A rank that raises
fails the whole world: the others are stopped and the traceback is
raised in the caller.

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


# -- the world ----------------------------------------------------------------

def _rank_main(rank, world, init_file, program, q):
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
        out = globals()[program](rank)
        q.put((rank, True, out))
    except Exception:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(program, nprocs=WORLD, timeout=240):
    """Each rank's ``program(rank)`` result, in rank order."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='nbk-torch-world-')
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, os.path.join(tmp, 'init'),
                               program, q))
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


def _refused(P, cat, pm):
    """The names of the calls with no multi-rank branch yet that raise
    NotImplementedError (at P = 1 each runs, so none is tried). Each is
    built on the P-rank mesh of ``cat`` and ``pm``."""
    from nbodykit_tpu_torch.forward import ForwardModel
    from nbodykit_tpu_torch.lab import (FOF, Bispectrum, HaloCatalog,
                                        KDDensity, Planck15,
                                        PopulatedHaloCatalog)
    if P == 1:
        return []
    calls = {'FOF': lambda: FOF(cat, 0.2, 2),
             'KDDensity': lambda: KDDensity(cat),
             'sort': lambda: cat.sort('Index'),
             'save': lambda: cat.save('unused-path'),
             'poisson': lambda: cat.rng.poisson(1.0),
             'Bispectrum': lambda: Bispectrum(cat, nbins=2, Nmesh=8,
                                              method='fft'),
             'ForwardModel': lambda: ForwardModel(8, comm=pm.comm),
             'PopulatedHaloCatalog': lambda: PopulatedHaloCatalog(
                 {'Position': np.zeros((8, 3))}, comm=pm.comm),
             'HaloCatalog': lambda: HaloCatalog(cat, Planck15, 0.5)}
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

def parallel_cases(rank):
    """The substrate: capacities, the exchange, halos, transforms,
    paints, readouts, draws, gathers."""
    import torch
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.parallel import dfft
    from nbodykit_tpu_torch.parallel.exchange import (auto_capacity,
                                                      counted_capacity,
                                                      exchange_by_dest)
    from nbodykit_tpu_torch.parallel.halo import halo_add, halo_fill
    from nbodykit_tpu_torch.pmesh import ParticleMesh
    from nbodykit_tpu_torch.rng import DistributedRNG
    from nbodykit_tpu_torch.source.catalog import UniformCatalog
    from nbodykit_tpu_torch.utils import (GatherArray, ScatterArray,
                                          get_data_bounds)
    T = torch.as_tensor
    out = {}
    fin = fft_inputs()
    field = readout_field()
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
        d = particles(NPARTS[0])
        pos, mass = T(rows(d['pos'], P, r)), T(rows(d['mass'], P, r))
        pm = ParticleMesh(NMESH, BOX, dtype='f8', comm=mesh)
        for method, window in PAINT_CASES:
            with nbodykit_tpu_torch.set_options(paint_method=method):
                out['paint', method, window, P] = _np(
                    pm.paint(pos, mass, resampler=window))
        real = T(slab(field, P, r))
        for window in READOUT_WINDOWS:
            out['readout', window, P] = _np(pm.readout(real, pos,
                                                       resampler=window))
        # rows split unevenly over the ranks, and two fields read at once
        uneven = T(rows(particles(NPARTS[1])['pos'], P, r))
        out['readout_uneven', P] = _np(pm.readout(real, uneven,
                                                  resampler='cic'))
        out['readout_many', P] = [_np(v) for v in pm.readout_many(
            [real, 2 * real], uneven, resampler='tsc')]
        out['readout_one', P] = _np(pm.readout(2 * real, uneven,
                                               resampler='tsc'))
        for case, call in (
                ('paint_retry', lambda: pm.paint(pos, mass, capacity=4)),
                ('readout_retry', lambda: pm.readout(real, pos,
                                                     capacity=4))):
            with _retries(pm) as seen:
                out[case, P] = dict(value=_np(call()))
            out[case, P].update(retries=len(seen),
                                capacity=seen[-1] if seen else 4)
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
        out['refused', P] = _refused(P, cat, pm)
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
    """The FFT algorithms, then the mesh algorithms and sources
    (SV_CASES), across ranks: every rank's result at each rank count."""
    import nbodykit_tpu_torch
    from nbodykit_tpu_torch.lab import (FFTCorr, FFTPower,
                                        ProjectedFFTPower, UniformCatalog)
    lab = dict(set_options=nbodykit_tpu_torch.set_options,
               FFTPower=FFTPower, FFTCorr=FFTCorr,
               ProjectedFFTPower=ProjectedFFTPower)
    out = {}
    survey_lab = port_lab()
    for P, mesh in _meshes():
        cat = UniformCatalog(nbar=CAT_NBAR, BoxSize=CAT_BOX, seed=42,
                             comm=mesh)
        for case in FFT_CASES:
            out[case, P] = fft_case(lab, cat, case)
        for case in SV_CASES:
            t0 = time.perf_counter()
            out[case, P] = survey_case(survey_lab, case, mesh)
            out[case, P]['seconds'] = time.perf_counter() - t0
    return out


# the mesh algorithms and mesh sources on the slab path
# (test_torch_dist_fftpower.py): surveys through ConvolvedFFTPower, BAO
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
