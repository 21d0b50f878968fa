"""Gadget1File: the classic Gadget-1 F77-unformatted snapshot.

A copy of ``nbodykit_tpu/io/gadget.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/gadget.py:36`` — a 256-byte header record, then
per-column F77 records (4-byte length, payload, 4-byte length), with
per-particle-type slicing via the header's Npart.

This implementation handles the standard (no block-name) variant with
the default column set; per-record sizes are validated against the F77
markers the same way the reference does.
"""

import numpy as np

from .base import FileType

DefaultHeaderDtype = np.dtype([
    ('Npart', ('u4', 6)),
    ('Massarr', ('f8', 6)),
    ('Time', 'f8'),
    ('Redshift', 'f8'),
    ('FlagSfr', 'i4'),
    ('FlagFeedback', 'i4'),
    ('Nall', ('u4', 6)),
    ('FlagCooling', 'i4'),
    ('NumFiles', 'i4'),
    ('BoxSize', 'f8'),
    ('Omega0', 'f8'),
    ('OmegaLambda', 'f8'),
    ('HubbleParam', 'f8'),
])

DefaultColumnDefs = [
    ('Position', ('auto', 3), (0, 1, 2, 3, 4, 5)),
    ('GadgetVelocity', ('auto', 3), (0, 1, 2, 3, 4, 5)),
    ('ID', 'auto', (0, 1, 2, 3, 4, 5)),
]


class Gadget1File(FileType):
    """Gadget-1 snapshot reader for one particle type.

    Parameters
    ----------
    path : file path
    columndefs : list of (name, dtype-or-'auto' spec, ptypes) defining
        the record layout after the header
    hdtype : header dtype (must define Npart, Massarr)
    ptype : which particle type to expose
    """

    def __init__(self, path, columndefs=DefaultColumnDefs,
                 hdtype=DefaultHeaderDtype, ptype=1):
        self.path = path
        self.ptype = ptype
        hdtype = np.dtype(hdtype)

        with open(path, 'rb') as ff:
            marker = np.fromfile(ff, dtype='i4', count=1)[0]
            if marker != 256:
                raise IOError("expected a 256-byte Gadget header record, "
                              "got marker %d" % marker)
            header = np.fromfile(ff, dtype=np.dtype(
                [('header', hdtype),
                 ('pad', ('u1', 256 - hdtype.itemsize))]), count=1)
            header = header[0]['header']
            end = np.fromfile(ff, dtype='i4', count=1)[0]
            if end != 256:
                raise IOError("corrupt Gadget header record")

        self.header = header
        self.attrs = {k: header[k] for k in header.dtype.names}
        npart = header['Npart']
        self.size = int(npart[ptype])

        # walk the records to locate each column
        dtype = []
        offsets = {}
        with open(path, 'rb') as ff:
            ptr = 256 + 8
            for name, spec, ptypes in columndefs:
                Ntot = int(sum(npart[p] for p in ptypes))
                nmemb = 1
                base = spec
                if isinstance(spec, tuple):
                    base, nmemb = spec[0], int(np.prod(spec[1:]))

                ff.seek(ptr, 0)
                a = int(np.fromfile(ff, dtype='i4', count=1)[0])
                itemsize = a // max(Ntot, 1) // nmemb if Ntot else 4
                if base == 'auto':
                    if name == 'ID':
                        base = 'u%d' % itemsize
                    else:
                        base = 'f%d' % itemsize
                sub = (base, (3,)) if nmemb == 3 else base
                blocksize = Ntot * nmemb * np.dtype(base).itemsize
                ff.seek(ptr + 4 + blocksize, 0)
                b = int(np.fromfile(ff, dtype='i4', count=1)[0])
                if a != b or a != blocksize:
                    raise IOError(
                        "F77 record size mismatch for %r: %d / %d / %d"
                        % (name, a, blocksize, b))
                # offset of this ptype within the record
                before = int(sum(npart[p] for p in ptypes
                                 if p < ptype))
                offsets[name] = ptr + 4 + before * nmemb * \
                    np.dtype(base).itemsize
                dtype.append((name, np.dtype(base), (3,)) if nmemb == 3
                             else (name, np.dtype(base)))
                ptr += 4 + blocksize + 4

        self.dtype = np.dtype(dtype)
        self.offsets = offsets

    def read(self, columns, start, stop, step=1):
        out = self._empty(columns, len(range(start, stop, step)))
        with open(self.path, 'rb') as ff:
            for col in columns:
                sub = self.dtype[col]
                ff.seek(self.offsets[col] + start * sub.itemsize, 0)
                data = np.fromfile(ff, dtype=sub.base,
                                   count=(stop - start)
                                   * int(np.prod(sub.shape, dtype=int)))
                out[col] = data.reshape((stop - start,)
                                        + sub.shape)[::step]
        return out
