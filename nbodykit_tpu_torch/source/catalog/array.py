"""ArrayCatalog: in-memory columns as a CatalogSource (counterpart of
``nbodykit_tpu/source/catalog/array.py``)."""

import numpy as np

from ...base.catalog import CatalogSource


class ArrayCatalog(CatalogSource):
    """A catalog built from a dict of arrays (numpy or tensors) or a
    structured numpy array; the columns are moved to ``device``.

    data : dict of (name -> array) or structured array, all of one
        length; device : 'cuda' or 'cpu' (default: the ``device``
        option, else 'cuda'); **kwargs : stored in :attr:`attrs`
    """

    def __init__(self, data, device=None, **kwargs):
        if isinstance(data, np.ndarray) and data.dtype.names is not None:
            data = {name: data[name] for name in data.dtype.names}
        if not isinstance(data, dict):
            raise TypeError("data must be a dict of arrays or a "
                            "structured numpy array")
        sizes = {k: np.shape(v)[0] for k, v in data.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError("column length mismatch: %s" % sizes)
        size = next(iter(sizes.values())) if sizes else 0

        CatalogSource.__init__(self, size, device=device)
        self.attrs.update(kwargs)
        for name, value in data.items():
            self[name] = value
