"""The PyTorch port stands alone: no module of ``nbodykit_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, importing the port
loads neither, and its entry points refuse to fall back to the CPU
quietly when CUDA is absent."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'nbodykit_tpu_torch')


def _forbidden(name):
    return (name == 'jax' or name.startswith('jax.')
            or name == 'nbodykit_tpu' or name.startswith('nbodykit_tpu.'))


def _port_files():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    return sorted(files)


def test_forbidden_prefix_spares_the_port():
    assert _forbidden('jax') and _forbidden('jax.numpy')
    assert _forbidden('nbodykit_tpu') and _forbidden('nbodykit_tpu.ops')
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
    code = ("import sys; before = set(sys.modules); "
            "import nbodykit_tpu_torch, nbodykit_tpu_torch.lab, "
            "nbodykit_tpu_torch._build, nbodykit_tpu_torch.convert; "
            "added = set(sys.modules) - before; "
            "bad = sorted(m for m in added if m == 'jax' or "
            "m.startswith('jax.') or m == 'nbodykit_tpu' or "
            "m.startswith('nbodykit_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_refuse_cpu_without_asking():
    from nbodykit_tpu_torch import set_options
    from nbodykit_tpu_torch.lab import (ArrayCatalog, ParticleMesh,
                                        UniformCatalog, catalog_from_numpy)
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with set_options(device=None):
        for make in (lambda: ParticleMesh(8, 1.0),
                     lambda: UniformCatalog(1e-3, 100.0, seed=1),
                     lambda: ArrayCatalog({'x': np.zeros(3)}),
                     lambda: catalog_from_numpy(
                         {'Position': np.zeros((3, 3))}, 1.0)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        # asking for the CPU, per call or by option, works
        assert ParticleMesh(8, 1.0, device='cpu').device.type == 'cpu'
    with set_options(device='cpu'):
        assert ParticleMesh(8, 1.0).device.type == 'cpu'


def test_auto_options_resolve_by_device():
    from nbodykit_tpu_torch import resolve_paint
    cpu = resolve_paint(torch.device('cpu'))
    assert (cpu['paint_method'], cpu['paint_order']) == ('scatter',
                                                        'argsort')
    cuda = resolve_paint(torch.device('cuda'))
    assert (cuda['paint_method'], cuda['paint_order']) == ('mxu', 'radix')


def test_kernel_wrappers_refuse_cpu_tensors():
    from nbodykit_tpu_torch.ops.paint_cuda import deposit_blocks_cuda
    from nbodykit_tpu_torch.ops.radix_cuda import pass_rank_hist_cuda
    with pytest.raises(ValueError):
        pass_rank_hist_cuda(torch.zeros(8, dtype=torch.int32), 4)
    z = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError):
        deposit_blocks_cuda(z, z, z, z, resampler='cic', rb=2, cb=2, n0l=8,
                            p0=8, N1=8, N2=8, origin=0)
