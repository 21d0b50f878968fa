"""FileStack: a concatenated view over many files of one type.

A copy of ``nbodykit_tpu/io/stack.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/stack.py:9`` — glob a path pattern, open each
file with the given FileType class, and expose the concatenation under
the same read contract.
"""

from glob import glob

import numpy as np

from .base import FileType


class FileStack(FileType):

    def __init__(self, filetype, path, *args, **kwargs):
        if isinstance(path, str):
            paths = sorted(glob(path))
            if len(paths) == 0:
                raise FileNotFoundError("no files match %r" % path)
        else:
            paths = list(path)
        self.files = [filetype(p, *args, **kwargs) for p in paths]
        self.paths = paths

        dtypes = {f.dtype for f in self.files}
        if len(dtypes) != 1:
            raise ValueError("inconsistent dtypes across the stack")
        self.dtype = self.files[0].dtype
        self.sizes = np.array([f.size for f in self.files])
        self.size = int(self.sizes.sum())
        self.starts = np.concatenate([[0], np.cumsum(self.sizes)])
        self.attrs = dict(getattr(self.files[0], 'attrs', {}))

    @property
    def nfiles(self):
        return len(self.files)

    def read(self, columns, start, stop, step=1):
        chunks = []
        for i, f in enumerate(self.files):
            lo, hi = self.starts[i], self.starts[i + 1]
            s = max(start, lo)
            e = min(stop, hi)
            if s >= e:
                continue
            chunks.append(f.read(columns, s - lo, e - lo))
        if not chunks:
            return self._empty(columns, 0)
        out = np.concatenate(chunks)
        return out[::step]
