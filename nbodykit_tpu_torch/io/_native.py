"""ctypes binding of the native bigfile reader (counterpart of
``nbodykit_tpu/io/_native.py``).

The library is the repo's root ``csrc/bigfile_io.cpp``, built by ``g++``
with the JAX package's flags (``-pthread`` added) into
``nbodykit_tpu_torch/_build/`` at first use
(:func:`nbodykit_tpu_torch._build.load_host`). :func:`read_block` reads
a block's part files with one thread per file segment, and
:func:`checksum` is the format's 32-bit byte sum.

Unlike the JAX package's loader, a failed build or a non-zero return
raises: nothing falls back to the numpy loop, which a caller selects
only with ``BigFileDataset.read(..., native=False)``.
"""

import ctypes
import os

import numpy as np

from .. import _build

LIBRARY = 'bigfile_io'


_UBYTES = ctypes.POINTER(ctypes.c_ubyte)


def native_available():
    """True when the library builds and loads here (``g++`` present);
    the solve itself raises on a failed build."""
    try:
        _lib()
    except Exception:
        return False
    return True


def _lib():
    lib = _build.load_host(LIBRARY)
    lib.nbk_bigfile_read.restype = ctypes.c_int
    lib.nbk_bigfile_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.c_long, ctypes.c_long, _UBYTES, ctypes.c_int]
    lib.nbk_checksum.restype = ctypes.c_uint
    lib.nbk_checksum.argtypes = [_UBYTES, ctypes.c_long]
    return lib


def checksum(data):
    """32-bit byte sum of an array's payload."""
    buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return int(_lib().nbk_checksum(buf.ctypes.data_as(_UBYTES), buf.size))


def read_block(bdir, bounds, dtype, nmemb, start, stop, nthreads=None):
    """Records [start, stop) of the block at ``bdir`` (part files split
    at ``bounds``) in a new array, one reader thread per part-file
    segment. Raises ``IndexError`` on a range outside the block and
    ``OSError`` when the library reports a failed open, seek or short
    read."""
    lib = _lib()
    nfile = len(bounds) - 1
    itemsize = np.dtype(dtype).itemsize * nmemb
    if not (0 <= start <= stop <= bounds[-1]):
        raise IndexError("record range [%d, %d) outside block of size %d"
                         % (start, stop, bounds[-1]))
    n = stop - start
    shape = (n, nmemb) if nmemb > 1 else (n,)
    if n == 0:
        return np.empty(shape, dtype=dtype)
    out = np.empty(n * nmemb, dtype=dtype)
    bounds_c = np.ascontiguousarray(bounds, dtype=np.int64)
    if nthreads is None:
        nthreads = min(max(os.cpu_count() or 1, 1), 16)
    rc = lib.nbk_bigfile_read(
        bdir.encode(), nfile,
        bounds_c.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        itemsize, start, stop, out.ctypes.data_as(_UBYTES), nthreads)
    if rc != 0:
        raise OSError("bigfile read of records [%d, %d) under %s failed "
                      "(return code %d)" % (start, stop, bdir, rc))
    return out.reshape(shape)
