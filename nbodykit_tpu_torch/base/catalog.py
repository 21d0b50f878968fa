"""CatalogSource: a table of particle columns (counterpart of
``nbodykit_tpu/base/catalog.py``).

A column is a tensor on the catalog's ``device``. Hardcolumns declared
with the ``column`` decorator are computed on first access and cached;
``attrs`` carries the metadata. A slice, mask or index selection gives
an ArrayCatalog of the selected rows; :meth:`view` a shallow view whose
new columns stay off the base.

With a ``comm`` of P ranks (a :class:`~..parallel.runtime.RankMesh`)
each rank holds its own rows: ``size`` is this rank's row count and
``csize`` the total (a collective); a column given whole is cut to this
rank's rows (``shard_leading``); selections act on this rank's rows and
:meth:`~CatalogSource.gslice` on global indices.
"""

import logging

import numpy as np
import torch

from .. import resolve_device
from ..parallel.runtime import CurrentMesh, mesh_size, \
    require_one_rank, row_range, shard_leading
from ..utils import as_numpy


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

    def __init__(self, device=None, comm=None):
        self.comm = CurrentMesh.resolve(comm)
        if self.comm is not None:
            if device is not None and \
                    resolve_device(device) != self.comm.device:
                raise ValueError("device %s differs from the comm's %s"
                                 % (device, self.comm.device))
            device = self.comm.device
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
        if isinstance(sel, (np.ndarray, list)):
            sel = torch.as_tensor(np.asarray(sel), device=self.device)
        if not isinstance(sel, (slice, torch.Tensor)):
            raise KeyError("invalid catalog selection %r" % (sel,))
        return self._rows_catalog({col: self[col][sel]
                                   for col in self.columns}, self.attrs)

    def _rows_catalog(self, data, attrs):
        """An ArrayCatalog of these columns, taken as this rank's rows,
        with a copy of ``attrs``."""
        from ..source.catalog.array import rows_catalog
        return rows_catalog(data, self.comm, self.device, attrs)

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

    def compute(self, *args):
        """The named columns (names resolve to tensors, anything else
        passes through); one argument gives one value. Columns are
        already computed, so nothing else happens."""
        out = [self[a] if isinstance(a, str) else a for a in args]
        return out[0] if len(out) == 1 else out

    def get_hardcolumn(self, col):
        return self[col]

    def __finalize__(self, other):
        self.attrs.update(getattr(other, 'attrs', {}))
        return self

    @staticmethod
    def make_column(array):
        """An array-like as a column tensor (on its own device; setting
        it on a catalog moves it to the catalog's)."""
        return torch.as_tensor(array)

    @staticmethod
    def create_instance(cls, device=None, comm=None):
        """A bare instance of ``cls`` with only the base state set: no
        columns, empty ``attrs``."""
        obj = object.__new__(cls)
        CatalogSourceBase.__init__(obj, device=device, comm=comm)
        return obj

    def copy(self):
        """A shallow copy holding the current columns, with an
        ``attrs`` of its own."""
        toret = CatalogSourceBase.create_instance(self.__class__,
                                                  device=self.device,
                                                  comm=self.comm)
        toret._size = len(self)
        toret.__finalize__(self)
        for col in self.columns:
            toret[col] = self[col]
        toret.attrs = dict(self.attrs)
        return toret

    def persist(self, columns=None):
        """An ArrayCatalog of the selected columns (default: all) with
        this catalog's ``attrs``."""
        return self._rows_catalog(
            {key: self[key] for key in (columns or self.columns)},
            self.attrs)

    def _promote(self, value, col=None):
        """Coerce a column value to a tensor of length len(self) on the
        catalog's device (scalars broadcast). With P ranks a value whose
        length is not this rank's row count is taken as the whole column
        and cut to this rank's rows."""
        size = len(self)
        if np.isscalar(value):
            value = torch.full((size,), value, device=self.device)
        else:
            value = torch.as_tensor(value, device=self.device)
        if value.shape[0] != size and mesh_size(self.comm) > 1:
            start, stop = row_range(value.shape[0], self.comm.size,
                                    self.comm.rank)
            if stop - start == size:
                value = shard_leading(self.comm, value)
        if value.shape[0] != size:
            raise ValueError(
                "size mismatch setting column%s: got %d, catalog has %d"
                % ('' if col is None else " '%s'" % col, value.shape[0],
                   size))
        return value

    def to_mesh(self, Nmesh=None, BoxSize=None, dtype=None,
                interlaced=False, compensated=False, resampler='cic',
                position='Position', weight='Weight', value='Value',
                selection='Selection'):
        """A CatalogMesh that paints this catalog on its device;
        ``dtype=None`` takes the ``mesh_dtype`` option ('auto' is
        'f4')."""
        from .. import resolve_mesh_dtype
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
        if dtype is None:
            dtype = resolve_mesh_dtype()
        return CatalogMesh(self, Nmesh=Nmesh, BoxSize=BoxSize, dtype=dtype,
                           interlaced=interlaced, compensated=compensated,
                           resampler=resampler, position=position,
                           weight=weight, value=value, selection=selection)

    def save(self, output, columns=None, dataset=None, datasets=None,
             header='Header'):
        """Write ``columns`` (default: every column, the default
        Selection/Weight/Value/Index included) and ``attrs`` as a
        bigfile directory (:mod:`nbodykit_tpu_torch.io.bigfile`), each
        column fetched to the host first. ``datasets`` renames the
        blocks; ``dataset`` is accepted for the JAX signature and
        unused, as there."""
        from ..io.bigfile import BigFileWriter
        if columns is None:
            columns = self.columns
        if datasets is None:
            datasets = columns
        require_one_rank(self, 'CatalogSource.save')
        with BigFileWriter(output, create=True) as ff:
            ff.write_attrs(header, self.attrs)
            for col, ds in zip(columns, datasets):
                ff.write(ds, as_numpy(self[col]))

    def read(self, columns):
        return [self[col] for col in columns]

    def to_subvolumes(self, domain=None, position='Position',
                      columns=None):
        """A copy of this catalog sorted into spatial subvolumes
        (:class:`~nbodykit_tpu_torch.source.catalog.subvolumes.SubVolumesCatalog`)."""
        from ..source.catalog.subvolumes import SubVolumesCatalog
        return SubVolumesCatalog(self, domain=domain, position=position,
                                 columns=columns)


class CatalogSource(CatalogSourceBase):
    """A catalog with a definite size (this rank's rows) and the default
    Selection/Weight/Value/Index columns."""

    def __init__(self, size, device=None, comm=None):
        CatalogSourceBase.__init__(self, device=device, comm=comm)
        self._size = int(size)

    def __len__(self):
        return self._size

    @property
    def size(self):
        return self._size

    @property
    def csize(self):
        """The collective size: the rows of every rank (a collective
        when there are several)."""
        if mesh_size(self.comm) == 1:
            return self._size
        return int(self.comm.all_reduce(
            torch.tensor([self._size], device=self.device)))

    def _row_offset(self):
        """The global index of this rank's first row (a collective)."""
        if mesh_size(self.comm) == 1:
            return 0
        sizes = self.comm.all_gather(
            torch.tensor([self._size], device=self.device)).reshape(-1)
        return int(sizes[:self.comm.rank].sum())

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
        """The global index of each row (a collective with several
        ranks)."""
        return self._row_offset() + torch.arange(
            self._size, dtype=torch.int64, device=self.device)

    def gslice(self, start, stop, step=1):
        """The rows ``start:stop:step`` of the global catalog as an
        ArrayCatalog (each rank keeps those of its own rows; a positive
        step with P ranks)."""
        if mesh_size(self.comm) == 1:
            return self._select(slice(start, stop, step))
        a, b, c = slice(start, stop, step).indices(self.csize)
        if c <= 0:
            raise ValueError("gslice across ranks takes a positive step")
        g = self._row_offset() + torch.arange(self._size,
                                              device=self.device)
        return self._select((g >= a) & (g < b) & ((g - a) % c == 0))

    def concatenate(self, *others):
        """This catalog and ``others`` end to end
        (:func:`~nbodykit_tpu_torch.transform.ConcatenateSources`)."""
        from ..transform import ConcatenateSources
        return ConcatenateSources(self, *others)

    def sort(self, keys, reverse=False, usecols=None):
        """An ArrayCatalog of the ``usecols`` columns (default: all)
        sorted by one or more scalar columns, the first key most
        significant: a stable argsort of the last key, then a stable
        pass for each earlier key. On one rank ``reverse`` flips the
        whole order, so ties come out in reverse catalog order too, as
        on one device in the JAX package.

        Across ranks, as the JAX package on a mesh: the columns map to
        order-preserving keys (:func:`..parallel.sort.sortable_key`,
        inverted for ``reverse``), one stable distributed sort a key
        from the last (:func:`..parallel.sort.dist_sort`, carrying the
        earlier keys and the global row index), then each column's rows
        are looked up by that index
        (:func:`..parallel.domain.gather_by_index`). Ties keep their
        catalog order, under ``reverse`` too; each rank holds its row
        split of the result."""
        from ..source.catalog.array import ArrayCatalog
        if isinstance(keys, str):
            keys = [keys]
        cols = usecols or self.columns
        if mesh_size(self.comm) > 1:
            from ..parallel.domain import gather_by_index
            from ..parallel.sort import dist_sort, sortable_key
            cur = [sortable_key(self[k], reverse) for k in keys]
            perm = self._row_offset() + torch.arange(
                self._size, dtype=torch.int64, device=self.device)
            for j in range(len(cur) - 1, -1, -1):
                _, out = dist_sort(cur[j], cur[:j] + [perm], self.comm)
                cur, perm = out[:j], out[j]
            return self._rows_catalog(
                {c: gather_by_index(perm, self[c], self.comm) for c in cols},
                self.attrs)
        order = torch.argsort(self[keys[-1]], stable=True)
        for key in reversed(keys[:-1]):
            order = order[torch.argsort(self[key][order], stable=True)]
        if reverse:
            order = order.flip(0)
        data = {c: self[c][order] for c in cols}
        return ArrayCatalog(data, device=self.device, **self.attrs)
