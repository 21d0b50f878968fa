"""The PyTorch port stands alone: no module of ``nbodykit_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or ``ml_dtypes`` (JAX's
bfloat16 for numpy, absent where the port runs), importing the port
loads none of them, and its entry points refuse to fall back to the CPU
quietly when CUDA is absent."""

import ast
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'nbodykit_tpu_torch')


def _forbidden(name):
    return any(name == top or name.startswith(top + '.')
               for top in ('jax', 'nbodykit_tpu', 'ml_dtypes'))


def _port_files():
    files = [os.path.join(ROOT, 'chip_smoke.py'),
             os.path.join(ROOT, 'tests', '_torch_ranks.py')]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    return sorted(files)


def test_forbidden_prefix_spares_the_port():
    assert _forbidden('jax') and _forbidden('jax.numpy')
    assert _forbidden('nbodykit_tpu') and _forbidden('nbodykit_tpu.ops')
    assert _forbidden('ml_dtypes') and not _forbidden('ml_dtypes_x')
    assert not _forbidden('nbodykit_tpu_torch')
    assert not _forbidden('nbodykit_tpu_torch.ops.paint')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)


def test_import_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "before = set(sys.modules); "
            "import nbodykit_tpu_torch, nbodykit_tpu_torch.lab, "
            "nbodykit_tpu_torch.parallel, "
            "nbodykit_tpu_torch.parallel.runtime, "
            "nbodykit_tpu_torch.parallel.exchange, "
            "nbodykit_tpu_torch.parallel.halo, "
            "nbodykit_tpu_torch.parallel.dfft, "
            "nbodykit_tpu_torch.parallel.domain, "
            "nbodykit_tpu_torch.parallel.sort, _torch_ranks, "
            "nbodykit_tpu_torch._build, nbodykit_tpu_torch.convert, "
            "nbodykit_tpu_torch.transform, "
            "nbodykit_tpu_torch.algorithms.convpower, "
            "nbodykit_tpu_torch.algorithms.fftcorr, "
            "nbodykit_tpu_torch.algorithms.zhist, "
            "nbodykit_tpu_torch.algorithms.fof, "
            "nbodykit_tpu_torch.algorithms.fftrecon, "
            "nbodykit_tpu_torch.hod, nbodykit_tpu_torch.meshtools, "
            "nbodykit_tpu_torch.source.catalog.species, "
            "nbodykit_tpu_torch.source.mesh.species, "
            "nbodykit_tpu_torch.io, nbodykit_tpu_torch.io._native, "
            "nbodykit_tpu_torch.source.catalog.file, "
            "nbodykit_tpu_torch.source.catalog.subvolumes, "
            "nbodykit_tpu_torch.source.mesh.bigfile, "
            "nbodykit_tpu_torch.algorithms.pair_counters, "
            "nbodykit_tpu_torch.algorithms.paircount_tpcf, "
            "nbodykit_tpu_torch.algorithms.threeptcf, "
            "nbodykit_tpu_torch.algorithms.kdtree, "
            "nbodykit_tpu_torch.algorithms.cgm, "
            "nbodykit_tpu_torch.algorithms.fibercollisions, "
            "nbodykit_tpu_torch.ops.paircount_cuda, "
            "nbodykit_tpu_torch.ops.threept_cuda, "
            "nbodykit_tpu_torch.forward, "
            "nbodykit_tpu_torch.algorithms.bispectrum, "
            "nbodykit_tpu_torch.ops.pairblock; "
            "added = set(sys.modules) - before; "
            "bad = sorted(m for m in added if m.split('.')[0] in "
            "('jax', 'nbodykit_tpu', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_cpu_without_asking():
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.lab import (ArrayCatalog, ArrayMesh,
                                        LinearMesh, LogNormalCatalog,
                                        ParticleMesh, UniformCatalog,
                                        catalog_from_numpy)
    from nbodykit_tpu_torch import rng, transform
    from nbodykit_tpu_torch.algorithms.fof import _fof_labels
    from nbodykit_tpu_torch.lab import FFTRecon, FOF
    from nbodykit_tpu_torch.lab import (BigFileCatalog, BigFileMesh,
                                        FileCatalog, io)
    from nbodykit_tpu_torch.ops.threefry_cuda import threefry_fill
    from nbodykit_tpu_torch.rng import DistributedRNG
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    plin = lambda k: k * 0 + 1.0                       # noqa: E731
    with set_options(device=None):
        for make in (lambda: ParticleMesh(8, 1.0),
                     lambda: UniformCatalog(1e-3, 100.0, seed=1),
                     lambda: ArrayCatalog({'x': np.zeros(3)}),
                     lambda: catalog_from_numpy(
                         {'Position': np.zeros((3, 3))}, 1.0),
                     lambda: LinearMesh(plin, 100.0, 8, seed=1),
                     lambda: ArrayMesh(np.zeros((4, 4, 4)), 1.0),
                     lambda: LogNormalCatalog(plin, 1e-3, 100.0, 8, seed=1),
                     lambda: DistributedRNG(1, 10),
                     lambda: rng.random_bits(rng.key(1), 32, (4,)),
                     lambda: rng.uniform(rng.key(1), (4,)),
                     lambda: rng.normal(rng.key(1), (4,)),
                     lambda: rng.poisson(rng.key(1), np.ones(4)),
                     lambda: threefry_fill(rng.key(1), 0, 4, 'bits32'),
                     lambda: transform.StackColumns(np.zeros(3)),
                     lambda: transform.ConstantArray(1.0, 3),
                     lambda: transform.SkyToUnitSphere(np.zeros(3),
                                                       np.zeros(3)),
                     lambda: transform.CartesianToEquatorial(
                         np.zeros((3, 3))),
                     lambda: transform.VectorProjection(np.ones((3, 3)),
                                                        [0, 0, 1]),
                     lambda: transform.HaloRadius(np.ones(3) * 1e12, None,
                                                  0.0),
                     lambda: FOF(ArrayCatalog({'Position': np.zeros((3, 3))},
                                              BoxSize=1.0), 0.2, 2),
                     lambda: _fof_labels(np.zeros((3, 3)), np.ones(3), 0.1),
                     lambda: FFTRecon(UniformCatalog(1e-3, 100.0, seed=1),
                                      UniformCatalog(1e-3, 100.0, seed=2),
                                      Nmesh=8),
                     lambda: BigFileCatalog('no-such-dir'),
                     lambda: FileCatalog(io.BinaryFile, 'no-such-file',
                                         dtype=[('x', 'f8')]),
                     lambda: BigFileMesh('no-such-dir')):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        # asking for the CPU, per call or by option, works
        assert ParticleMesh(8, 1.0, device='cpu').device.type == 'cpu'
    with set_options(device='cpu'):
        assert ParticleMesh(8, 1.0).device.type == 'cpu'


def test_survey_entry_points_follow_their_catalogs():
    """The survey classes run where their catalogs are, so a catalog
    made without CUDA must have asked for the CPU; MultipleSpeciesCatalog
    refuses species on different devices."""
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.lab import (ArrayCatalog, ConvolvedFFTPower,
                                        FKPCatalog, MultipleSpeciesCatalog)
    cols = {'Position': np.random.RandomState(0).uniform(0, 10, (50, 3)),
            'NZ': np.full(50, 0.05)}
    if not torch.cuda.is_available():
        with set_options(device=None):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                FKPCatalog(ArrayCatalog(cols), ArrayCatalog(cols))
    data = ArrayCatalog(cols, device='cpu')
    fkp = FKPCatalog(data, ArrayCatalog(cols, device='cpu'))
    assert fkp.device.type == 'cpu'
    r = ConvolvedFFTPower(fkp.to_mesh(Nmesh=8), poles=[0], dk=0.2)
    assert np.isfinite(r.poles['power_0'][r.poles['modes'] > 0]).all()

    class Elsewhere(object):
        device = torch.device('meta')
        attrs = {}
    with pytest.raises(ValueError, match='different devices'):
        MultipleSpeciesCatalog(['a', 'b'], data, Elsewhere())


def test_auto_options_resolve_by_device():
    from nbodykit_tpu_torch import resolve_paint
    cpu = resolve_paint(torch.device('cpu'))
    assert (cpu['paint_method'], cpu['paint_order']) == ('scatter',
                                                        'argsort')
    cuda = resolve_paint(torch.device('cuda'))
    assert (cuda['paint_method'], cuda['paint_order']) == ('mxu', 'radix')


def test_kernel_wrappers_refuse_cpu_tensors():
    from nbodykit_tpu_torch.ops.fof_cuda import fof_sweep_cuda
    from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_cuda
    from nbodykit_tpu_torch.ops.radix_cuda import pass_rank_hist_cuda
    n = 4
    with pytest.raises(ValueError, match='CUDA tensors'):
        fof_sweep_cuda(torch.zeros((n, 3)), torch.zeros((n, 3),
                                                         dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int32),
                       torch.ones(n, dtype=torch.bool),
                       torch.arange(n, dtype=torch.int32), [(0, 0, 0)],
                       [1, 1, 1], [1.0, 1.0, 1.0], 0.01, True)
    with pytest.raises(ValueError):
        pass_rank_hist_cuda(torch.zeros(8, dtype=torch.int32), 4)
    z = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError):
        deposit_blocks_cuda(z, z, z, z, resampler='cic', rb=2, cb=2, n0l=8,
                            p0=8, N1=8, N2=8, origin=0)


def test_particle_kernel_wrappers_refuse_cpu_tensors():
    from nbodykit_tpu_torch.ops.devicehash import GridHash
    from nbodykit_tpu_torch.ops.paircount_cuda import paircount_hist_cuda
    from nbodykit_tpu_torch.ops.threept_cuda import threept_alm_cuda
    pos = torch.as_tensor(np.random.RandomState(0).uniform(0, 10, (20, 3)))
    grid = GridHash(pos, np.full(3, 10.0), 3.0)
    w = torch.ones(20, dtype=torch.float64)
    live = torch.ones(20, dtype=torch.bool)
    ci = grid.cell_of(grid.pos_s)
    with pytest.raises(ValueError, match='CUDA tensors'):
        paircount_hist_cuda(grid, w, grid.pos_s, w, live, ci,
                            np.array([1.0, 4.0]), '1d', is_auto=True)
    with pytest.raises(ValueError, match='CUDA tensors'):
        threept_alm_cuda(grid, w, grid.pos_s, live, ci,
                         np.array([1.0, 4.0]), [0, 2])


def _port_module(name):
    """The port's counterpart of JAX-package module ``name``, if any."""
    import importlib.util
    port = 'nbodykit_tpu_torch' + name[len('nbodykit_tpu'):]
    try:
        return importlib.util.find_spec(port) is not None
    except ModuleNotFoundError:
        return False


def test_lab_exports_every_ported_name():
    """Every name of the JAX package's ``lab`` whose module has a
    counterpart in the port is exported by the port's ``lab``."""
    import types
    import nbodykit_tpu.lab as jlab
    import nbodykit_tpu_torch.lab as tlab
    missing, checked = [], 0
    for name in dir(jlab):
        if name.startswith('_'):
            continue
        obj = getattr(jlab, name)
        module = obj.__name__ if isinstance(obj, types.ModuleType) \
            else getattr(obj, '__module__', None)
        if not module or not module.startswith('nbodykit_tpu'):
            continue
        if not _port_module(module):
            continue
        checked += 1
        if not hasattr(tlab, name) and \
                '%s.%s' % (module, name) not in OMISSIONS:
            missing.append('%s (%s)' % (name, module))
    assert not missing, "the port's lab lacks %s" % missing
    for name in ('Planck15', 'FKPPower', 'FOF', 'HaloCatalog', 'FFTRecon',
                 'TopHat', 'setup_logging', 'timer', 'meshtools', 'io', 'IO',
                 'BigFileCatalog', 'FITSCatalog', 'BigFileMesh',
                 'SubVolumesCatalog', 'FileCatalogFactory',
                 'SimulationBoxPairCount', 'SurveyDataPairCount',
                 'PairCountBase', 'SimulationBox2PCF', 'SurveyData2PCF',
                 'WedgeBinnedStatistic', 'SimulationBox3PCF',
                 'SurveyData3PCF', 'YlmCache', 'KDDensity',
                 'CylindricalGroups', 'FiberCollisions', 'Bispectrum'):
        assert hasattr(tlab, name), name
    assert checked >= 50, checked
    assert tlab.FKPPower is tlab.ConvolvedFFTPower
    assert tlab.IO is tlab.io


# Public names of the JAX package that the port leaves out on purpose,
# each with its reason. Queue A is ROADMAP.md's queue of modules to port.
_PENCIL = 'the pencil decomposition of the distributed FFT (ROADMAP Queue A)'
_LOWMEM = ("the JAX single-device lowmem FFT programs (ROADMAP Queue A); "
           "the port's ParticleMesh.forward_slabs transforms slab by slab")
_SHARDING = 'JAX-only: a NamedSharding of a jax.sharding.Mesh'
OMISSIONS = {
    'nbodykit_tpu.ops.devicehash.DeviceGridHash.pvary':
        'JAX-only: marks a value as varying over a shard_map axis',
    'nbodykit_tpu.pmesh.ParticleMesh.sharding': _SHARDING,
    'nbodykit_tpu.parallel.runtime.sharding': _SHARDING,
    'nbodykit_tpu.parallel.runtime.tpu_mesh':
        'TPU-only: a mesh of TPU devices',
    'nbodykit_tpu.parallel.runtime.reform_decomposition':
        'the relaunch plan of resilience/ (ROADMAP Queue A)',
    'nbodykit_tpu.parallel.runtime.default_pencil_factor': _PENCIL,
    'nbodykit_tpu.parallel.runtime.pencil_mesh': _PENCIL,
    'nbodykit_tpu.parallel.runtime.is_pencil': _PENCIL,
    'nbodykit_tpu.parallel.runtime.mesh_shape2d': _PENCIL,
    'nbodykit_tpu.parallel.runtime.leading_axes': _PENCIL,
    'nbodykit_tpu.parallel.dfft.rfftn_single_lowmem': _LOWMEM,
    'nbodykit_tpu.parallel.dfft.irfftn_single_lowmem': _LOWMEM,
    'nbodykit_tpu.parallel.dfft.fftn_c2c_single_lowmem': _LOWMEM,
    'nbodykit_tpu.base.mesh.Field.tree_flatten':
        'JAX-only: registers Field as a pytree',
    'nbodykit_tpu.base.mesh.Field.tree_unflatten':
        'JAX-only: registers Field as a pytree',
    'nbodykit_tpu.utils.is_mxu_backend':
        'JAX-only: asks whether the backend is a TPU',
    'nbodykit_tpu.ops.histogram.hist2d_mxu':
        'JAX-only: the one-hot matrix-unit histogram of the TPU',
    'nbodykit_tpu.ops.radix.stable_order':
        'JAX-only: picks the counting sort on TPU backends; the port '
        'names its engine (ops.radix.order_keys)',
    'nbodykit_tpu.ops.radix.pad_digits':
        "JAX-only: static-shape padding of the XLA rank pass; the port's "
        'rank kernel takes ragged lengths',
    'nbodykit_tpu.utils.to_device_complex':
        'JAX-only: moves complex arrays as real/imag pairs for a TPU '
        'runtime without complex transfers',
    'nbodykit_tpu.ops.histogram.hist2d_bincount':
        "the port's hist2d_weighted is this bincount form on every "
        'device',
    'nbodykit_tpu.ops.gridhash.GridHash':
        "the port's GridHash is ops.devicehash.GridHash, the one grid "
        'engine of every particle algorithm',
}


def _public_definitions(module):
    """{name: ast node} of the public functions and classes a module
    defines, and of the public callables it assigns at top level."""
    import ast
    import types
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                obj = getattr(module, getattr(t, 'id', ''), None)
                if isinstance(t, ast.Name) and callable(obj) and \
                        not isinstance(obj, types.ModuleType):
                    out[t.id] = node
    return {k: v for k, v in out.items() if not k.startswith('_')}


def test_port_defines_every_jax_name():
    """Every public function and class, and every public method of a
    public class, that a JAX module with a port counterpart defines
    exists in the port, but for the written omissions; and no omission
    exists in the port (the list stays true)."""
    import ast
    import importlib
    import pkgutil
    import nbodykit_tpu
    missing, present, checked = [], [], 0
    names = ['nbodykit_tpu'] + [
        m.name for m in pkgutil.walk_packages(nbodykit_tpu.__path__,
                                              'nbodykit_tpu.')]
    for name in names:
        if not _port_module(name):
            continue
        jmod = importlib.import_module(name)
        tmod = importlib.import_module(
            'nbodykit_tpu_torch' + name[len('nbodykit_tpu'):])
        for attr, node in _public_definitions(jmod).items():
            found = [('%s.%s' % (name, attr), hasattr(tmod, attr))]
            if found[0][1] and isinstance(node, ast.ClassDef):
                cls = getattr(tmod, attr)
                found += [('%s.%s.%s' % (name, attr, b.name),
                           hasattr(cls, b.name)) for b in node.body
                          if isinstance(b, ast.FunctionDef)
                          and not b.name.startswith('_')]
            for qual, has in found:
                checked += 1
                if qual in OMISSIONS:
                    if has:
                        present.append(qual)
                elif not has:
                    missing.append(qual)
    assert not missing, "the port lacks %s" % missing
    assert not present, "listed as omitted but ported: %s" % present
    assert checked >= 500, checked
    assert all(OMISSIONS.values())


# Parameters of the JAX package that the port does not take, by name
# wherever they appear: the JAX-only knobs, each with its reason.
JAX_ONLY_PARAMETERS = {
    'chunk': "the static chunk of a traced XLA loop; the port's kernels "
             'and eager loops size their own work',
    'engine': 'picks between XLA lowerings of the rank pass; the port '
              'names its engine (ops.radix.order_keys)',
    'method': "picks the TPU's one-hot histogram; the port's "
              'hist2d_weighted is the bincount form on every device',
    'acc_dtype': "the TPU histogram's accumulator; the port bins in f64",
    'deposit': 'picks the Pallas or the XLA deposit; the port launches '
               'its one deposit kernel on the card',
    'axis_name': "the shard_map axis of a JAX device mesh; the port's "
                 'ranks are processes (parallel.runtime.RankMesh)',
    'coordinator_address': "jax.distributed's coordinator; the port's "
                           'init_distributed takes init_method',
    'local_device_ids': "jax.distributed's devices of a process; the "
                        "port's init_distributed takes device",
    'pm_or_nproc': 'the rank count as an int or a ParticleMesh; the port '
                   'takes the RankMesh itself',
    'nproc': 'the rank count; the port takes the RankMesh itself',
}
# Parameters of one JAX function that the port does not take, each with
# its reason.
PARAMETER_OMISSIONS = {
    'nbodykit_tpu.parallel.sort.dist_sort': (
        ('slack',),
        "the bucket capacity's headroom; the counted exchange sizes the "
        'buckets exactly'),
    'nbodykit_tpu.parallel.domain.gather_by_index': (
        ('size',),
        "the table's length; the port's follows from the ranks' rows"),
    'nbodykit_tpu.pmesh.memory_plan': (
        ('fft_decomp', 'fft_pencil', 'ingest_chunk_rows', 'catalog_bytes'),
        'memory_plan prices the slab path only: the pencil decomposition '
        'and the ingest workload come with their slices (ROADMAP Queue A '
        'items 1.3 and 2)'),
}


def _parameter_names(obj):
    """The names of the named parameters of a callable (a class: its
    constructor's), or None when it has no signature."""
    import inspect
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def test_port_takes_every_jax_parameter():
    """Every named parameter of every public function, class and public
    method that the JAX package defines and the port ports is a named
    parameter of the port's counterpart (a ``**kwargs`` that swallows it
    does not count), but for the JAX-only knobs and the written
    omissions; and every written omission is still missing (the lists
    stay true)."""
    import ast
    import importlib
    import pkgutil
    import nbodykit_tpu
    missing, present, checked = [], [], 0
    names = ['nbodykit_tpu'] + [
        m.name for m in pkgutil.walk_packages(nbodykit_tpu.__path__,
                                              'nbodykit_tpu.')]
    for name in names:
        if not _port_module(name):
            continue
        jmod = importlib.import_module(name)
        tmod = importlib.import_module(
            'nbodykit_tpu_torch' + name[len('nbodykit_tpu'):])
        for attr, node in _public_definitions(jmod).items():
            if not hasattr(tmod, attr):
                continue
            pairs = [(attr, getattr(jmod, attr), getattr(tmod, attr))]
            if isinstance(node, ast.ClassDef):
                jcls, tcls = pairs[0][1:]
                pairs += [('%s.%s' % (attr, b.name), getattr(jcls, b.name),
                           getattr(tcls, b.name)) for b in node.body
                          if isinstance(b, ast.FunctionDef)
                          and not b.name.startswith('_')
                          and hasattr(tcls, b.name)]
            for qual, jobj, tobj in pairs:
                qual = '%s.%s' % (name, qual)
                jp, tp = _parameter_names(jobj), _parameter_names(tobj)
                if jp is None or tp is None:
                    continue
                checked += 1
                omitted, _ = PARAMETER_OMISSIONS.get(qual, ((), None))
                for p in jp:
                    if p in JAX_ONLY_PARAMETERS:
                        continue
                    if p in omitted:
                        if p in tp:
                            present.append('%s(%s)' % (qual, p))
                    elif p not in tp:
                        missing.append('%s(%s)' % (qual, p))
    assert not missing, "the port does not take %s" % missing
    assert not present, "listed as omitted but taken: %s" % present
    assert checked >= 450, checked
    assert all(JAX_ONLY_PARAMETERS.values())
    assert all(reason for _, reason in PARAMETER_OMISSIONS.values())


def _two_ranks(rank=0, group=None):
    """A 2-rank mesh that runs no collective: enough to build what takes
    a ``comm`` and to see it refuse or cut its rows."""
    from nbodykit_tpu_torch.parallel.runtime import RankMesh
    return RankMesh(group, [0, 1], rank, 'cpu', 'gloo')


@pytest.mark.parametrize('rank', [0, 1])
def test_array_mesh_takes_its_comm(rank):
    """ArrayMesh(array, BoxSize, comm=): each rank keeps its x-slab of
    the array every rank passes whole, and ``comm`` is the mesh's, not
    an attr."""
    from nbodykit_tpu_torch.lab import ArrayMesh
    a = np.random.RandomState(0).standard_normal((4, 4, 4))
    comm = _two_ranks(rank)
    mesh = ArrayMesh(a, 1.0, comm=comm, device='cpu', tag=7)
    assert mesh.comm is comm and mesh.pm.comm is comm
    assert mesh.pm.nproc == 2 and 'comm' not in mesh.attrs
    assert mesh.attrs['tag'] == 7
    np.testing.assert_array_equal(mesh.to_real_field().value.numpy(),
                                  a[2 * rank:2 * rank + 2])
    one = ArrayMesh(a, 1.0, device='cpu')
    assert one.comm is None
    np.testing.assert_array_equal(one.to_real_field().value.numpy(), a)


def test_containers_take_their_inputs_comm():
    """MultipleSpeciesCatalog takes its species' comm and refuses
    species on different meshes; its mesh and FKPCatalog follow it;
    HaloCatalog takes its source's comm and rows (across ranks too);
    FFTRecon refuses data and randoms on different meshes."""
    from nbodykit_tpu_torch.lab import (ArrayCatalog, FFTRecon, FKPCatalog,
                                        HaloCatalog, MultipleSpeciesCatalog,
                                        Planck15)
    comm = _two_ranks()
    cols = {'Position': np.random.RandomState(1).uniform(0, 1, (6, 3)),
            'NZ': np.ones(6)}
    a = ArrayCatalog(cols, comm=comm)
    assert len(a) == 3 and a.comm is comm
    both = MultipleSpeciesCatalog(['x', 'y'], a, a)
    assert both.comm is comm and len(both) == 6
    mesh = both.to_mesh(Nmesh=4, BoxSize=1.0)
    assert mesh.comm is comm and mesh.pm.nproc == 2
    assert FKPCatalog(a, a).comm is comm
    one = ArrayCatalog(cols, device='cpu')
    assert MultipleSpeciesCatalog(['x', 'y'], one, one).comm is None
    with pytest.raises(ValueError, match='different meshes'):
        MultipleSpeciesCatalog(['x', 'y'], a, one)
    other = ArrayCatalog(cols, comm=_two_ranks(group=object()))
    aa = ArrayCatalog(cols, comm=_two_ranks(group=object()))
    with pytest.raises(ValueError, match='different meshes'):
        MultipleSpeciesCatalog(['x', 'y'], aa, other)
    with pytest.raises(ValueError, match='different meshes'):
        FFTRecon(aa, other, Nmesh=4, BoxSize=1.0)
    assert HaloCatalog(one, Planck15, 0.5).comm is None
    halos = HaloCatalog(a, Planck15, 0.5)
    assert halos.comm is comm and len(halos) == 3


def test_constructors_take_comm_and_refuse_ranks():
    """Each constructor and function that the JAX package gives a
    ``comm`` takes one; those whose branch across ranks is not ported
    refuse a 2-rank mesh, and LinearMesh, FieldMesh of a Field and
    ForwardModel run on it. (The direct bispectrum, ``pairblock_sum`` and
    FiberCollisions run across ranks: tests/test_torch_dist_groups.py.)"""
    from nbodykit_tpu_torch import io, set_options
    from nbodykit_tpu_torch.algorithms.bispectrum import direct_bispectrum
    from nbodykit_tpu_torch.base.mesh import Field, FieldMesh
    from nbodykit_tpu_torch.forward import ForwardModel
    from nbodykit_tpu_torch.lab import (BigFileMesh, LinearMesh,
                                        LogNormalCatalog, ParticleMesh)
    from nbodykit_tpu_torch.source.catalog import file as fc
    comm = _two_ranks()
    plin = lambda k: k * 0 + 1.0                       # noqa: E731
    pos = np.random.RandomState(2).uniform(0, 10, (5, 3))
    refused = {
        'LogNormalCatalog': lambda: LogNormalCatalog(
            plin, 1e-3, 100.0, 8, seed=1, comm=comm),
        'BigFileMesh': lambda: BigFileMesh('no-such-dir', comm=comm),
        'FieldMesh': lambda: FieldMesh(torch.zeros((4, 4, 4)),
                                       BoxSize=1.0, comm=comm),
        'FileCatalogBase': lambda: fc.FileCatalogBase(
            io.CSVFile, args=('no-such-file',), comm=comm),
        'FileCatalog': lambda: fc.FileCatalog(io.CSVFile, 'no-such-file',
                                              comm=comm),
    }
    for name in ('CSVCatalog', 'BinaryCatalog', 'BigFileCatalog',
                 'HDFCatalog', 'FITSCatalog', 'TPMBinaryCatalog',
                 'Gadget1Catalog'):
        refused[name] = functools.partial(getattr(fc, name),
                                          'no-such-file', comm=comm)
    with set_options(device='cpu'):
        for name, make in refused.items():
            with pytest.raises(NotImplementedError, match='one rank'):
                make()
        lin = LinearMesh(plin, 100.0, 8, seed=1, comm=comm)
        assert lin.comm is comm and lin.pm.nproc == 2
        pm = ParticleMesh(4, 1.0, comm=comm)
        fm = FieldMesh(Field(pm.create(), pm))
        assert fm.comm is comm
        model = ForwardModel(4, comm=comm)
        assert model.pm.comm is comm and model.lattice is model.pm
        assert tuple(model.white_guess().shape) == (2, 4, 4)
        # at one rank each takes comm=None
        assert LinearMesh(plin, 100.0, 8, seed=1, comm=None).comm is None
        B, _ = direct_bispectrum(pos, np.ones(5), 10.0, 2, comm=None)
        assert B.shape == (2, 2, 2)
        assert FieldMesh(torch.zeros((4, 4, 4)), BoxSize=1.0,
                         comm=None).comm is None


class _MirrorRanks(object):
    """The collectives of a world of ``size`` ranks that all hold the
    same rows: enough for a collective entry point to run on one
    process."""

    def __init__(self, size=2, rank=0):
        from nbodykit_tpu_torch.parallel.runtime import RankMesh
        self.mesh = RankMesh(None, range(size), rank, 'cpu', 'gloo')
        self.mesh.all_reduce = lambda t, op='sum': \
            t * size if op == 'sum' else t.clone()
        self.mesh.all_gather = lambda t: torch.stack([t] * size)
        self.mesh.broadcast = lambda t, src=0: t.clone()
        self.mesh.all_to_all = self._all_to_all

    def _all_to_all(self, send, send_splits=None, recv_splits=None):
        # rank r sends this rank the block this rank sends rank r's twin
        m = self.mesh
        blocks = torch.split(send, send_splits or
                             [send.shape[0] // m.size] * m.size)
        return torch.cat([blocks[m.rank]] * m.size)


def test_populate_keeps_the_halos_comm():
    """HODModel.populate of a 2-rank HaloCatalog builds its galaxies on
    the halos' comm, from every rank's halos: rank 0 keeps the first
    rows of the one-rank population of both ranks' halos, and a seed
    drawn for ``seed=None`` is rank 0's."""
    from nbodykit_tpu_torch.lab import (ArrayCatalog, HaloCatalog,
                                        HODModel, Planck15, Zheng07Model)
    from nbodykit_tpu_torch.parallel.runtime import row_range
    rs = np.random.RandomState(5)
    cols = {'Position': rs.uniform(0, 100.0, (40, 3)),
            'Velocity': rs.normal(0, 50.0, (40, 3)),
            'Mass': 10 ** rs.uniform(12.5, 15.0, 40)}
    mesh = _MirrorRanks().mesh
    local = ArrayCatalog(cols, device='cpu', BoxSize=100.0)
    halos = HaloCatalog(local, Planck15, 0.5)
    halos.comm = mesh
    both = HaloCatalog(ArrayCatalog(
        {k: np.concatenate([v, v]) for k, v in cols.items()}, device='cpu',
        BoxSize=100.0), Planck15, 0.5)
    model = Zheng07Model(logMmin=12.5, logM1=13.5)
    gal = halos.populate(model, seed=11)
    one = both.populate(model, seed=11)
    assert gal.comm is halos.comm
    start, stop = row_range(len(one), 2, 0)
    assert len(gal) == stop - start > 0
    for c in ('Position', 'Velocity', 'gal_type', 'HaloMass'):
        np.testing.assert_array_equal(gal[c].numpy(), one[c][:stop].numpy())
    drawn = HODModel(model)
    seed = drawn.seed
    mesh.broadcast = lambda t, src=0: t * 0 + seed + 1
    assert drawn.populate(halos).attrs['seed'] == seed + 1 == drawn.seed


def test_preview_root_and_return_dropped():
    """MeshSource.preview takes ``root`` (the projection is the same on
    every rank); ParticleMesh.paint and readout take ``return_dropped``
    and drop nothing."""
    from nbodykit_tpu_torch.lab import ArrayMesh, ParticleMesh
    a = np.random.RandomState(3).standard_normal((4, 4, 4))
    mesh = ArrayMesh(a, 1.0, device='cpu')
    np.testing.assert_allclose(mesh.preview(axes=[0], root=1),
                               a.sum(axis=(1, 2)), rtol=1e-14)
    np.testing.assert_array_equal(mesh.preview(root=0), a)
    pm = ParticleMesh(4, 1.0, dtype='f8', device='cpu')
    pos = torch.as_tensor(np.random.RandomState(4).uniform(0, 1, (20, 3)))
    field, dropped = pm.paint(pos, return_dropped=True)
    assert dropped == 0
    torch.testing.assert_close(field, pm.paint(pos), rtol=0, atol=0)
    vals, dropped = pm.readout(field, pos, return_dropped=True)
    assert dropped == 0
    torch.testing.assert_close(vals, pm.readout(field, pos), rtol=0,
                               atol=0)


def test_lab_star_import_runs_the_benchmark_idiom():
    ns = {}
    exec("from nbodykit_tpu_torch.lab import *\n"
         "plin = LinearPower(Planck15, 0.55, 'EisensteinHu')\n"
         "names = (FKPPower, FOF, HaloCatalog, FFTRecon, TopHat, "
         "BigFileCatalog, BigFileMesh, SubVolumesCatalog, IO)", ns)
    assert float(ns['plin'](np.array([0.1]))[0]) > 0


def test_timer_logs_its_block(caplog):
    import logging
    from nbodykit_tpu_torch import setup_logging, timer
    setup_logging('info')
    with caplog.at_level(logging.INFO, logger='timer'):
        with timer('phase'):
            pass
    assert any(r.getMessage().startswith('phase: ') and
               r.getMessage().endswith(' s') for r in caplog.records)
    setup_logging('warning')
