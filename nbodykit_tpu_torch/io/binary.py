"""BinaryFile: columns appended in a single binary file.

A copy of ``nbodykit_tpu/io/binary.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/binary.py:43`` — a flat binary file holding
columns of fixed dtype one after another (with optional header offsets).
"""

import os

import numpy as np

from .base import FileType


class BinaryFile(FileType):
    """Column-appended binary file.

    Parameters
    ----------
    path : file path
    dtype : list of (name, dtype[, itemshape]) — column layout, in file
        order
    offsets : optional dict of column -> byte offset; default assumes
        columns stored back-to-back after ``header_size`` bytes
    header_size : bytes to skip at the start
    size : number of rows; inferred from the file size when None
    """

    def __init__(self, path, dtype, offsets=None, header_size=0,
                 size=None):
        self.path = path
        self.dtype = np.dtype(dtype)
        fsize = os.path.getsize(path)

        if offsets is not None and not isinstance(offsets, dict):
            raise TypeError("offsets must be a dict of column -> byte "
                            "offset, got %s" % type(offsets).__name__)
        if offsets is not None:
            missing = [n for n in self.dtype.names if n not in offsets]
            if missing:
                raise ValueError("offsets missing columns: %s" % missing)

        if size is None:
            payload = fsize - header_size
            # the exact-multiple check encodes the back-to-back-after-
            # header layout, which only holds without custom offsets
            if offsets is None and (payload < 0
                                    or payload % self.dtype.itemsize):
                raise ValueError(
                    "cannot infer size: file has %d payload bytes, not "
                    "a multiple of the %d-byte row (wrong header_size "
                    "or dtype?)" % (payload, self.dtype.itemsize))
            size = max(payload, 0) // self.dtype.itemsize
        self.size = int(size)

        if offsets is None:
            offsets = {}
            off = header_size
            for name in self.dtype.names:
                offsets[name] = off
                sub = self.dtype[name]
                off += sub.itemsize * self.size
            if off > fsize:
                raise ValueError(
                    "file too small: need %d bytes for %d rows, have %d"
                    % (off, self.size, fsize))
        self.offsets = offsets

    def read(self, columns, start, stop, step=1):
        out = self._empty(columns, len(range(start, stop, step)))
        with open(self.path, 'rb') as ff:
            for col in columns:
                sub = self.dtype[col]
                ff.seek(self.offsets[col] + start * sub.itemsize)
                data = np.fromfile(
                    ff, dtype=sub.base,
                    count=(stop - start) * int(np.prod(sub.shape,
                                                       dtype=int)))
                data = data.reshape((stop - start,) + sub.shape)
                out[col] = data[::step]
        return out
