"""CatalogSource: a table of particle columns on one device (counterpart
of ``nbodykit_tpu/base/catalog.py``).

A column is a tensor on the catalog's ``device``. Hardcolumns declared
with the ``column`` decorator are computed on first access and cached;
``attrs`` carries the metadata. A slice, mask or index selection gives
an ArrayCatalog of the selected rows; :meth:`view` a shallow view whose
new columns stay off the base.
"""

import logging

import numpy as np
import torch

from .. import resolve_device


def column(name=None):
    """Decorator declaring a hardcolumn on a CatalogSource subclass; the
    method computes the column on first access, then it is cached."""
    def wrapper(func):
        func.column_name = name or func.__name__
        return func
    if callable(name):
        func, name = name, name.__name__
        return wrapper(func)
    return wrapper


def find_columns(cls):
    """Collect hardcolumn methods from a class hierarchy."""
    hard = {}
    for klass in reversed(cls.__mro__):
        for value in vars(klass).values():
            if callable(value) and hasattr(value, 'column_name'):
                hard[value.column_name] = value
    return hard


class CatalogSourceBase(object):
    """Dict-like base: column get/set, attrs, mesh conversion."""

    logger = logging.getLogger('CatalogSource')

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if not hasattr(self, 'attrs'):
            self.attrs = {}
        self._columns = {}     # explicitly set columns
        self._cache = {}       # evaluated hardcolumns

    @property
    def hardcolumns(self):
        return sorted(find_columns(type(self)))

    @property
    def columns(self):
        return sorted(set(self.hardcolumns) | set(self._columns))

    def __contains__(self, col):
        return col in self.columns

    def __getitem__(self, sel):
        if not isinstance(sel, str):
            return self._select(sel)
        if sel in self._columns:
            return self._columns[sel]
        if sel in self._cache:
            return self._cache[sel]
        hard = find_columns(type(self))
        if sel in hard:
            val = self._promote(hard[sel](self))
            self._cache[sel] = val
            return val
        raise KeyError("column '%s' not found; available: %s"
                       % (sel, self.columns))

    def __setitem__(self, col, value):
        self._columns[col] = self._promote(value, col=col)

    def __delitem__(self, col):
        if col in self._columns:
            del self._columns[col]
        elif col in self.hardcolumns:
            raise ValueError("cannot delete hardcolumn '%s'" % col)
        else:
            raise KeyError(col)

    def _select(self, sel):
        """An ArrayCatalog of the rows that a slice, a boolean mask or
        an index array (numpy, list or tensor) selects, every column
        sliced on the catalog's device."""
        from ..source.catalog.array import ArrayCatalog
        if isinstance(sel, (np.ndarray, list)):
            sel = torch.as_tensor(np.asarray(sel), device=self.device)
        if not isinstance(sel, (slice, torch.Tensor)):
            raise KeyError("invalid catalog selection %r" % (sel,))
        data = {col: self[col][sel] for col in self.columns}
        return ArrayCatalog(data, device=self.device, **self.attrs)

    def view(self, type=None):
        """A re-typed view sharing the column tensors; the column dicts
        are copied, so a column set on the view stays off the base."""
        obj = object.__new__(type or self.__class__)
        obj.__dict__.update(self.__dict__)
        obj._columns = dict(self._columns)
        obj._cache = dict(self._cache)
        obj._size = len(self)
        obj.base = self
        return obj

    def _promote(self, value, col=None):
        """Coerce a column value to a tensor of length len(self) on the
        catalog's device (scalars broadcast)."""
        size = len(self)
        if np.isscalar(value):
            value = torch.full((size,), value, device=self.device)
        else:
            value = torch.as_tensor(value, device=self.device)
        if value.shape[0] != size:
            raise ValueError(
                "size mismatch setting column%s: got %d, catalog has %d"
                % ('' if col is None else " '%s'" % col, value.shape[0],
                   size))
        return value

    def to_mesh(self, Nmesh=None, BoxSize=None, dtype='f4',
                interlaced=False, compensated=False, resampler='cic',
                position='Position', weight='Weight', value='Value',
                selection='Selection'):
        """A CatalogMesh that paints this catalog on its device."""
        from ..source.mesh.catalog import CatalogMesh
        if Nmesh is None:
            Nmesh = self.attrs.get('Nmesh', None)
            if Nmesh is None:
                raise ValueError("cannot infer Nmesh; pass it to to_mesh "
                                 "or set attrs['Nmesh']")
        if BoxSize is None:
            BoxSize = self.attrs.get('BoxSize', None)
            if BoxSize is None:
                raise ValueError("cannot infer BoxSize; pass it to "
                                 "to_mesh or set attrs['BoxSize']")
        return CatalogMesh(self, Nmesh=Nmesh, BoxSize=BoxSize, dtype=dtype,
                           interlaced=interlaced, compensated=compensated,
                           resampler=resampler, position=position,
                           weight=weight, value=value, selection=selection)


class CatalogSource(CatalogSourceBase):
    """A catalog with a definite size and the default
    Selection/Weight/Value/Index columns."""

    def __init__(self, size, device=None):
        CatalogSourceBase.__init__(self, device=device)
        self._size = int(size)

    def __len__(self):
        return self._size

    @property
    def size(self):
        return self._size

    def __repr__(self):
        return "%s(size=%d)" % (self.__class__.__name__, self._size)

    @column
    def Selection(self):
        return torch.ones(self._size, dtype=torch.bool, device=self.device)

    @column
    def Weight(self):
        return torch.ones(self._size, dtype=torch.float64,
                          device=self.device)

    @column
    def Value(self):
        return torch.ones(self._size, dtype=torch.float64,
                          device=self.device)

    @column
    def Index(self):
        return torch.arange(self._size, dtype=torch.int64,
                            device=self.device)

    def sort(self, keys, reverse=False, usecols=None):
        """An ArrayCatalog of the ``usecols`` columns (default: all)
        sorted by one or more scalar columns, the first key most
        significant: a stable argsort of the last key, then a stable
        pass for each earlier key. ``reverse`` flips the whole order, so
        ties come out in reverse catalog order too, as on one device in
        the JAX package."""
        from ..source.catalog.array import ArrayCatalog
        if isinstance(keys, str):
            keys = [keys]
        cols = usecols or self.columns
        order = torch.argsort(self[keys[-1]], stable=True)
        for key in reversed(keys[:-1]):
            order = order[torch.argsort(self[key][order], stable=True)]
        if reverse:
            order = order.flip(0)
        data = {c: self[c][order] for c in cols}
        return ArrayCatalog(data, device=self.device, **self.attrs)
