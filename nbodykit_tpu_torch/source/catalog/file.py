"""File-backed catalogs: one class per file format, via a factory
(counterpart of ``nbodykit_tpu/source/catalog/file.py``).

Reference: ``nbodykit/source/catalog/file.py:15,166`` — FileCatalogBase
wraps a FileType (or FileStack of them) as a CatalogSource; the factory
stamps out CSVCatalog, BinaryCatalog, BigFileCatalog, HDFCatalog,
FITSCatalog, TPMBinaryCatalog, Gadget1Catalog (file.py:232-238).
"""

import numpy as np
import torch

from ... import io as _io
from ... import resolve_device
from ...base.catalog import CatalogSource
from ...parallel.runtime import CurrentMesh, require_one_rank


class FileCatalogBase(CatalogSource):
    """A CatalogSource whose columns come from a file (stack).

    A column is read whole from the file on its first access and moved
    to the catalog's ``device`` ('cuda' unless the caller asks for the
    CPU); then it is cached. ``comm`` (default: the ambient mesh) must
    be one rank: the partitioned read is not ported.
    """

    def __init__(self, filetype, args=(), kwargs={}, comm=None,
                 device=None):
        # the device and the ranks first: without CUDA and without a
        # request for the CPU, or with several ranks, raise before any
        # file is opened
        device = resolve_device(device)
        require_one_rank(CurrentMesh.resolve(comm), 'FileCatalogBase')
        path = args[0] if args else kwargs.get('path')
        rest = args[1:]
        if isinstance(path, str) and ('*' in path or '?' in path):
            self._source = _io.FileStack(filetype, path, *rest, **kwargs)
        else:
            try:
                self._source = filetype(*args, **kwargs)
            except (IOError, OSError, FileNotFoundError):
                self._source = _io.FileStack(filetype, path, *rest,
                                             **kwargs)
        CatalogSource.__init__(self, self._source.size, device=device,
                               comm=comm)
        self.attrs.update(getattr(self._source, 'attrs', {}))

    @property
    def hardcolumns(self):
        base = CatalogSource.hardcolumns.fget(self)
        return sorted(set(base) | set(self._source.columns))

    def __getitem__(self, sel):
        if isinstance(sel, str) and sel not in self._columns and \
                sel not in self._cache and sel in self._source.columns:
            data = self._source.read([sel], 0, self._source.size)[sel]
            val = self._promote(torch.as_tensor(
                np.ascontiguousarray(data)))
            self._cache[sel] = val
            return val
        return CatalogSource.__getitem__(self, sel)


def _make_file_catalog(name, filetype, doc_fmt):
    def __init__(self, *args, comm=None, device=None, **kwargs):
        FileCatalogBase.__init__(self, filetype, args=args,
                                 kwargs=kwargs, comm=comm, device=device)
    cls = type(name, (FileCatalogBase,), {'__init__': __init__})
    cls.__doc__ = ("CatalogSource of a %s (reference factory: "
                   "nbodykit/source/catalog/file.py:232-238). Accepts "
                   "glob patterns for multi-file datasets; ``device`` "
                   "as for every catalog." % doc_fmt)
    return cls


CSVCatalog = _make_file_catalog('CSVCatalog', _io.CSVFile,
                                'delimited text file')
BinaryCatalog = _make_file_catalog('BinaryCatalog', _io.BinaryFile,
                                   'column-appended binary file')
BigFileCatalog = _make_file_catalog('BigFileCatalog', _io.BigFile,
                                    'bigfile column store')
HDFCatalog = _make_file_catalog('HDFCatalog', _io.HDFFile, 'HDF5 file')
FITSCatalog = _make_file_catalog('FITSCatalog', _io.FITSFile,
                                 'FITS binary table')
TPMBinaryCatalog = _make_file_catalog('TPMBinaryCatalog',
                                      _io.TPMBinaryFile, 'TPM snapshot')
Gadget1Catalog = _make_file_catalog('Gadget1Catalog', _io.Gadget1File,
                                    'Gadget-1 snapshot')


class FileCatalog(FileCatalogBase):
    """Generic file catalog taking the FileType class as its first
    argument (reference: nbodykit/source/catalog/file.py:202-231):
    ``FileCatalog(filetype, path, ...)``."""

    def __init__(self, filetype, path, *args, comm=None, device=None,
                 attrs=None, **kwargs):
        FileCatalogBase.__init__(self, filetype, args=(path,) + args,
                                 kwargs=kwargs, comm=comm, device=device)
        self.attrs.update(attrs or {})


def FileCatalogFactory(name, filetype, examples=None):
    """Create a CatalogSource class reading a custom
    :class:`~nbodykit_tpu_torch.io.base.FileType` subclass (reference
    factory: nbodykit/source/catalog/file.py:232-238). ``examples`` is
    accepted for signature parity and ignored."""
    return _make_file_catalog(
        name, filetype, getattr(filetype, '__name__', 'file'))
