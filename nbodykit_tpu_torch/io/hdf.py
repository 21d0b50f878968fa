"""HDFFile: column reads from HDF5 datasets via h5py.

A copy of ``nbodykit_tpu/io/hdf.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/hdf.py:43`` — exposes a (structured or group
of) HDF5 dataset(s) under the FileType contract.
"""

import numpy as np

from .base import FileType


class HDFFile(FileType):
    """HDF5 file reader.

    Parameters
    ----------
    path : file path
    dataset : name of the group or dataset to read (default '/')
    exclude : list of dataset names to skip
    """

    def __init__(self, path, dataset='/', exclude=None, header=None):
        import h5py
        self.path = path
        self.dataset = dataset
        exclude = exclude or []

        self._columns = {}
        self.attrs = {}
        with h5py.File(path, 'r') as ff:
            if dataset not in ff and dataset != '/':
                raise ValueError("no such group/dataset %r in %s"
                                 % (dataset, path))
            obj = ff[dataset]
            if exclude and not isinstance(obj, h5py.Dataset):
                # exclude is meaningless for a single structured
                # dataset (silently ignored there, as before)
                bad = [e for e in exclude if e not in obj.keys()]
                if bad:
                    raise ValueError("exclude names not in %r: %s"
                                     % (dataset, bad))
            self.attrs.update(dict(obj.attrs))
            if isinstance(obj, h5py.Dataset):
                if obj.dtype.names is None:
                    raise ValueError("dataset %r is not structured; "
                                     "point at a group" % dataset)
                self.size = obj.shape[0]
                self.dtype = obj.dtype
                self._single = True
            else:
                self._single = False
                dt = []
                sizes = {}
                for name, d in obj.items():
                    if name in exclude or not isinstance(d, h5py.Dataset):
                        continue
                    sizes[name] = d.shape[0]
                    itemshape = d.shape[1:]
                    dt.append((name, d.dtype, itemshape) if itemshape
                              else (name, d.dtype))
                if len(set(sizes.values())) > 1:
                    raise ValueError("dataset size mismatch: %s" % sizes)
                if not sizes:
                    raise ValueError("no datasets under %r in %s"
                                     % (dataset, path))
                self.size = next(iter(sizes.values()))
                self.dtype = np.dtype(dt)

    def read(self, columns, start, stop, step=1):
        import h5py
        out = self._empty(columns, len(range(start, stop, step)))
        with h5py.File(self.path, 'r') as ff:
            obj = ff[self.dataset]
            for col in columns:
                if self._single:
                    out[col] = obj[start:stop:step][col]
                else:
                    out[col] = obj[col][start:stop:step]
        return out
