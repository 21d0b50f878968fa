"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Libraries go
to ``nbodykit_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags, so an edit rebuilds. :func:`build_all`
starts one ``nvcc`` per source, all together.

A missing ``nvcc`` or a failed build raises with the compiler's output;
nothing falls back to the plain PyTorch versions.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')

FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-fmad=false', '-Xptxas', '-v']

_libs = {}


def sources():
    """Kernel names (file stems of ``csrc/*.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(SRC_DIR, '*.cu')))


def nvcc():
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which('nvcc')
    if found:
        return found
    path = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "$CUDA_HOME); the CUDA kernels cannot be built")


def _target(name):
    src = os.path.join(SRC_DIR, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(FLAGS).encode())
    return src, os.path.join(BUILD_DIR, 'lib%s_%s.so'
                             % (name, digest.hexdigest()[:16]))


def build_all(names=None):
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together. Returns {name: compiler output} for the sources
    compiled by this call (``-Xptxas -v`` register/spill report)."""
    names = sources() if names is None else list(names)
    todo = [(n,) + _target(n) for n in names]
    todo = [t for t in todo if not os.path.exists(t[2])]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, src, lib in todo:
        tmp = '%s.%d.tmp.so' % (lib[:-3], os.getpid())
        p = subprocess.Popen([exe] + FLAGS + ['-o', tmp, src],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((name, lib, tmp, p))
    logs, failed = {}, []
    for name, lib, tmp, p in procs:
        out, _ = p.communicate()
        logs[name] = out
        if p.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, p.returncode, out))
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed to build %s" % '\n'.join(failed))
    return logs


def load(name):
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _, path = _target(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        lib.nbk_error_string.argtypes = [ctypes.c_int]
        lib.nbk_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name, err):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = load(name).nbk_error_string(err).decode()
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, msg))
