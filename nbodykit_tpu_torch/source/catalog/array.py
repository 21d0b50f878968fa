"""ArrayCatalog: in-memory columns as a CatalogSource (counterpart of
``nbodykit_tpu/source/catalog/array.py``)."""

import numpy as np

from ...base.catalog import CatalogSource, CatalogSourceBase
from ...parallel.runtime import CurrentMesh, mesh_size, row_range


class ArrayCatalog(CatalogSource):
    """A catalog built from a dict of arrays (numpy or tensors) or a
    structured numpy array; the columns are moved to ``device``.

    data : dict of (name -> array) or structured array, all of one
        length; device : 'cuda' or 'cpu' (default: the comm's device,
        else the ``device`` option, else 'cuda'); comm : a RankMesh of
        P ranks, each given the whole columns and keeping its rows, as
        the JAX package shards a global column; **kwargs : stored in
        :attr:`attrs`
    """

    def __init__(self, data, device=None, comm=None, **kwargs):
        if isinstance(data, np.ndarray) and data.dtype.names is not None:
            data = {name: data[name] for name in data.dtype.names}
        if not isinstance(data, dict):
            raise TypeError("data must be a dict of arrays or a "
                            "structured numpy array")
        sizes = {k: np.shape(v)[0] for k, v in data.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError("column length mismatch: %s" % sizes)
        size = next(iter(sizes.values())) if sizes else 0
        comm = CurrentMesh.resolve(comm)
        if mesh_size(comm) > 1:
            start, stop = row_range(size, comm.size, comm.rank)
            size = stop - start

        CatalogSource.__init__(self, size, device=device, comm=comm)
        self.attrs.update(kwargs)
        for name, value in data.items():
            self[name] = value


def rows_catalog(data, comm, device=None, attrs=None):
    """An ArrayCatalog of columns that already hold this rank's rows of
    ``comm`` (the constructor takes whole columns and cuts them), with
    a copy of the dict ``attrs``; on one rank the constructor's
    catalog."""
    attrs = attrs or {}
    if mesh_size(comm) == 1:
        return ArrayCatalog(data, device=device, comm=comm, **attrs)
    obj = CatalogSourceBase.create_instance(ArrayCatalog, device, comm)
    obj._size = next(iter(data.values())).shape[0] if data else 0
    for name, value in data.items():
        obj[name] = value
    obj.attrs.update(attrs)
    return obj
