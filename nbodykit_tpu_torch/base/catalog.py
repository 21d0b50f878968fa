"""CatalogSource: a table of particle columns on one device (counterpart
of ``nbodykit_tpu/base/catalog.py``).

A column is a tensor on the catalog's ``device``. Hardcolumns declared
with the ``column`` decorator are computed on first access and cached;
``attrs`` carries the metadata.
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
            raise KeyError("column selection by %r is not ported yet"
                           % (sel,))
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
