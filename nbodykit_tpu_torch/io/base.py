"""FileType: the abstract partitioned-read contract.

A copy of ``nbodykit_tpu/io/base.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/base.py:7`` — a file exposes ``size``,
``dtype`` (structured), ``ncol``/``shape`` and
``read(columns, start, stop, step)`` returning a structured array.
The reference wraps files as dask arrays (``get_dask``); here catalogs
read slices directly into device arrays.
"""

import numpy as np


class FileType(object):
    """Abstract base for column-addressable partitioned file readers."""

    # subclasses set in __init__:
    size = None        # number of rows
    dtype = None       # numpy structured dtype

    def read(self, columns, start, stop, step=1):
        raise NotImplementedError

    @property
    def columns(self):
        return list(self.dtype.names)

    @property
    def shape(self):
        return (self.size,)

    @property
    def ncol(self):
        return len(self.dtype.names)

    def __len__(self):
        return self.size

    def __getitem__(self, sel):
        """Selection semantics mirroring the reference FileType
        (nbodykit/io/base.py getitem): a column name reads that column;
        a list of names returns a restricted view (IndexError on empty
        or unknown names — and a single-column view cannot be
        column-sliced again); a slice reads rows; a boolean mask or
        integer list reads the matching rows of all columns."""
        if isinstance(sel, str):
            if sel not in self.columns:
                raise IndexError("no such column: %r" % sel)
            return _ColumnSubset(self, [sel])
        if isinstance(sel, list) and all(isinstance(s, str)
                                         for s in sel):
            if not sel:
                raise IndexError("empty column selection")
            bad = [s for s in sel if s not in self.columns]
            if bad:
                raise IndexError("no such columns: %s" % bad)
            return _ColumnSubset(self, sel)
        if isinstance(sel, slice):
            start, stop, step = sel.indices(self.size)
            return self.read(self.columns, start, stop, step)
        sel = np.asarray(sel)
        if sel.dtype == bool or np.issubdtype(sel.dtype, np.integer):
            if sel.ndim != 1:
                raise IndexError("row selections must be 1-D")
            return self.read(self.columns, 0, self.size)[sel]
        raise KeyError(sel)

    def keys(self):
        return self.columns

    def row_range(self, rank, nranks):
        """This rank's exact ``[start, stop)`` row span under the
        balanced integer partition ``start = size*rank // nranks``.
        Spans tile the file exactly — no overlap, no dropped tail —
        whatever ``size % nranks`` is (the uneven-tail bug class the
        ingest property test pins across every reader)."""
        if not (0 <= rank < nranks):
            raise ValueError("rank %d not in [0, %d)" % (rank, nranks))
        size = int(self.size)
        return size * rank // nranks, size * (rank + 1) // nranks

    def read_chunks(self, columns, chunk_rows, rank=0, nranks=1):
        """Yield this rank's rows as structured-array chunks of at
        most ``chunk_rows`` — the uniform streaming interface every
        reader inherits (the ingest plane's bounded-host-RAM source).
        The final chunk carries the uneven tail; chunks are never
        padded here (the device pipeline pads to the mesh size)."""
        chunk_rows = int(chunk_rows)
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1, got %d"
                             % chunk_rows)
        start, stop = self.row_range(rank, nranks)
        for s in range(start, stop, chunk_rows):
            yield self.read(columns, s, min(s + chunk_rows, stop))

    def _empty(self, columns, n):
        dt = np.dtype([(c, self.dtype[c]) for c in columns])
        return np.empty(n, dtype=dt)

    def asarray(self):
        """All columns stacked into one unstructured (size, ncol*...)
        array (reference: FileType.asarray via dask.stack; eager
        here). Columns must share a base dtype."""
        base = {self.dtype[c].base for c in self.columns}
        if len(base) > 1:
            raise ValueError("asarray() requires a uniform column "
                             "dtype, have %s" % sorted(map(str, base)))
        data = self.read(self.columns, 0, self.size)
        cols = []
        for c in self.columns:
            a = data[c]
            cols.append(a.reshape(len(a), -1))
        return np.concatenate(cols, axis=1)

    def __repr__(self):
        return "%s(size=%d, ncol=%d)" % (self.__class__.__name__,
                                         self.size or 0, self.ncol)


class _ColumnSubset(FileType):
    """A column-restricted view of another FileType (what ``f[['a',
    'b']]`` returns); reads delegate to the parent."""

    def __init__(self, parent, columns):
        self._parent = parent
        self.dtype = np.dtype([(c, parent.dtype[c]) for c in columns])
        self.size = parent.size

    def read(self, columns, start, stop, step=1):
        bad = [c for c in columns if c not in self.dtype.names]
        if bad:
            raise IndexError("no such columns: %s" % bad)
        return self._parent.read(columns, start, stop, step)

    def __getitem__(self, sel):
        if (isinstance(sel, str) or isinstance(sel, list)) \
                and len(self.dtype.names) == 1:
            # reference contract: a single-column view is terminal
            raise IndexError(
                "cannot column-slice a single-column view")
        if isinstance(sel, slice):
            start, stop, step = sel.indices(self.size)
            # a one-column slice reads as a plain (unstructured) array
            if len(self.dtype.names) == 1:
                name = self.dtype.names[0]
                return self.read([name], start, stop, step)[name]
            return self.read(list(self.dtype.names), start, stop, step)
        return super(_ColumnSubset, self).__getitem__(sel)
