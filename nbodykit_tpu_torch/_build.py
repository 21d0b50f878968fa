"""Build the hand-written CUDA kernels (``csrc/*.cu``) and the host
libraries at first use.

Each CUDA source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; the
headers they share (``csrc/*.cuh``) are on the include path and in the
library's hash. The
host libraries (``HOST_SOURCES``: the native Einstein-Boltzmann solver
and the bigfile part-file reader, the repo's root
``csrc/boltzmann_kernel.cpp`` and ``csrc/bigfile_io.cpp``) are compiled
by ``g++`` with ``HOST_FLAGS`` plus the source's ``HOST_EXTRA_FLAGS``,
the flags the JAX package builds the same source with, so both packages
compute the same bits. Libraries go to
``nbodykit_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edit rebuilds. :func:`build_all` starts one
compiler per source, all together.

A missing compiler or a failed build raises with the compiler's output;
nothing falls back to the plain versions.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, 'csrc')
HOST_SRC_DIR = os.path.join(os.path.dirname(_HERE), 'csrc')
BUILD_DIR = os.path.join(_HERE, '_build')

FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-fmad=false', '-Xptxas', '-v',
         '-I', SRC_DIR]
HOST_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
HOST_SOURCES = ('boltzmann_kernel', 'bigfile_io')
# flags one host source adds to HOST_FLAGS (the reader's threads)
HOST_EXTRA_FLAGS = {'bigfile_io': ['-pthread']}

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


def gxx():
    """Path of ``g++`` (on PATH; ``nvcc`` needs it as its host
    compiler)."""
    found = shutil.which('g++')
    if found:
        return found
    raise RuntimeError("g++ not found on PATH; the host libraries cannot "
                       "be built")


def _host(name):
    return name in HOST_SOURCES


def host_flags(name):
    """The ``g++`` flags of host library ``name``."""
    return HOST_FLAGS + HOST_EXTRA_FLAGS.get(name, [])


def _target(name):
    if _host(name):
        src = os.path.join(HOST_SRC_DIR, name + '.cpp')
        flags = host_flags(name)
    else:
        src, flags = os.path.join(SRC_DIR, name + '.cu'), FLAGS
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags).encode())
    if not _host(name):
        # the headers the kernels share (csrc/*.cuh): an edit rebuilds
        for header in sorted(glob.glob(os.path.join(SRC_DIR, '*.cuh'))):
            with open(header, 'rb') as f:
                digest.update(f.read())
    return src, os.path.join(BUILD_DIR, 'lib%s_%s.so'
                             % (name, digest.hexdigest()[:16]))


def build_all(names=None):
    """Compile every library not built yet, one compiler per source
    (``nvcc`` for the kernels, ``g++`` for ``HOST_SOURCES``), all started
    together. ``names`` defaults to every kernel and host library.
    Returns {name: compiler output} for the sources compiled by this
    call (``-Xptxas -v`` register/spill report for the kernels)."""
    names = sources() + list(HOST_SOURCES) if names is None \
        else list(names)
    todo = [(n,) + _target(n) for n in names]
    todo = [t for t in todo if not os.path.exists(t[2])]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src, lib in todo:
        tmp = '%s.%d.tmp.so' % (lib[:-3], os.getpid())
        cmd = [gxx()] + host_flags(name) if _host(name) \
            else [nvcc()] + FLAGS
        p = subprocess.Popen(cmd + ['-o', tmp, src],
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
        raise RuntimeError("failed to build %s" % '\n'.join(failed))
    return logs


def load_host(name):
    """The loaded host library ``name`` (one of ``HOST_SOURCES``), built
    first if needed."""
    if not _host(name):
        raise ValueError("%r is not a host library (%s)"
                         % (name, HOST_SOURCES))
    lib = _libs.get(name)
    if lib is None:
        _, path = _target(name)
        if not os.path.exists(path):
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(path)
    return lib


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
