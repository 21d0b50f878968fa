"""bigfile: the column store used for catalog/mesh persistence
(counterpart of ``nbodykit_tpu/io/bigfile.py``; a directory written by
either package is the directory the other writes for the same data).

Reference capability: ``nbodykit/io/bigfile.py:16`` (reader over the
bigfile C library) used for ``CatalogSource.save`` (reference
base/catalog.py:562-703) and mesh save (base/mesh.py:367-412). bigfile
is the native format of FastPM / MP-Gadget snapshots, so reading and
writing the *actual* on-disk format (not a lookalike) is what lets data
flow between this framework and the wider simulation ecosystem.

On-disk format (rainwoodman/bigfile; plain files, written here with
numpy and read by the repo's native part-file reader, ``_native.py``):

    <root>/                     a bigfile is a directory
      <block>/                  a block (column) is a subdirectory
        header                  ASCII:  DTYPE: <f8
                                        NMEMB: 3
                                        NFILE: 2
                                        000000: 500 : <checksum>
                                        000001: 500 : <checksum>
        000000, 000001, ...     raw little-endian data, hex-named,
                                file i holding the i-th row range
        attr-v2                 one attribute per line:
                                ``<name> <dtype> <nmemb> <hex bytes>
                                #HUMANE [ <repr> ]``

Compatibility notes:

- per-file checksums are written as the 32-bit byte sum (the C
  library's sysv-style accumulator).  Unlike the C library (which
  never re-checks them), this reader VERIFIES each physical file's
  checksum the first time any of its rows are read, raising
  :class:`ChecksumMismatch` on divergence — the on-disk leg of the
  end-to-end integrity story (docs/INTEGRITY.md).  Opt out with
  ``set_options(io_verify_checksums=False)``; headers whose entries
  carry no checksum field — or a literal ``0`` placeholder, as some
  foreign writers emit — skip verification
  for those files rather than reject the whole block;
- attributes are parsed from the first four whitespace-separated
  fields; everything after the hex payload (the ``#HUMANE [...]``
  comment the C library appends) is ignored, and string values stored
  as ``json://``-prefixed S1 arrays round-trip through
  :class:`...utils.JSONDecoder` exactly as the reference readers do
  (reference io/bigfile.py:84-88);
- a tensor attribute is stored as its numpy array, as the JAX package
  stores a device array.
"""

import json
import os

import numpy as np
import torch

from .base import FileType
from ..utils import JSONEncoder, JSONDecoder, as_numpy

_HEADER = 'header'
_ATTRS = 'attr-v2'


class ChecksumMismatch(IOError):
    """A physical bigfile data file whose byte sum no longer matches
    the checksum its header recorded at write time — disk rot, a torn
    copy, or corruption in transfer.  Carries the exact provenance
    (file, column, expected, got) so the operator knows WHICH file to
    restore, not just that something is wrong."""

    def __init__(self, file, column, expected, got):
        self.file = str(file)
        self.column = str(column)
        self.expected = int(expected)
        self.got = int(got)
        super(ChecksumMismatch, self).__init__(
            'bigfile checksum mismatch in %s (column %s): header '
            'records %d, data sums to %d — restore the file or load '
            'with set_options(io_verify_checksums=False)'
            % (self.file, self.column, self.expected, self.got))


def _verify_enabled():
    from .. import _global_options
    return bool(_global_options['io_verify_checksums'])


def _checksum(data):
    """bigfile's per-physical-file checksum: 32-bit unsigned byte sum
    (the native library's)."""
    from . import _native
    return _native.checksum(np.frombuffer(data, dtype=np.uint8))


def _norm_dtype(dt):
    """numpy dtype -> bigfile DTYPE string ('<f8' style, explicit
    little-endian byte order for native types)."""
    dt = np.dtype(dt)
    s = dt.str
    if s[0] == '=':
        s = '<' + s[1:]
    return s


def _file_bounds(size, nfile):
    return np.linspace(0, size, nfile + 1).astype('i8')


# ------------------------------------------------------------ attributes

def _attr_encode(value):
    """Value -> (dtype_str, nmemb, raw_bytes). Strings become S1 arrays
    (the C library convention); everything else must be numpy-castable."""
    if isinstance(value, torch.Tensor):
        value = as_numpy(value)
    if isinstance(value, str):
        raw = value.encode('utf-8')
        return '|S1', len(raw), raw
    arr = np.asarray(value)
    if arr.dtype == object:
        raise ValueError("attribute of type %r is not storable"
                         % type(value))
    if arr.dtype.kind in 'SU':
        raw = arr.astype('S').tobytes()
        return '|S1', len(raw), raw
    if arr.dtype.byteorder == '>':
        arr = arr.astype(arr.dtype.newbyteorder('<'))
    return _norm_dtype(arr.dtype), int(arr.size), \
        np.ascontiguousarray(arr).tobytes()


def _attr_humane(value):
    try:
        arr = np.asarray(value)
        if arr.dtype.kind in 'SU' or isinstance(value, str):
            return str(value)
        return ' '.join(str(x) for x in np.atleast_1d(arr).ravel()[:8])
    except Exception:
        return ''


def write_attrs_file(bdir, attrs):
    """Serialize an attrs dict to ``<bdir>/attr-v2``. Values that are
    not numpy-castable are stored as ``json://`` strings (the
    reference's convention, base/catalog.py:676-683)."""
    lines = []
    for name in sorted(attrs):
        value = attrs[name]
        try:
            dt, nmemb, raw = _attr_encode(value)
        except (ValueError, TypeError):
            s = 'json://' + json.dumps(value, cls=JSONEncoder)
            dt, nmemb, raw = _attr_encode(s)
        lines.append('%s %s %d %s #HUMANE [ %s ]\n' % (
            name, dt, nmemb, raw.hex().upper(),
            _attr_humane(value)))
    with open(os.path.join(bdir, _ATTRS), 'w') as ff:
        ff.writelines(lines)


def read_attrs_file(bdir, decode_json=True):
    """Parse ``<bdir>/attr-v2``; missing file -> empty dict."""
    fn = os.path.join(bdir, _ATTRS)
    out = {}
    if not os.path.exists(fn):
        return out
    with open(fn) as ff:
        for line in ff:
            parts = line.split()
            if len(parts) < 3:
                continue
            name, dt, nmemb = parts[:3]
            # zero-length payloads leave the hex field empty, so the
            # next token (if any) is the #HUMANE comment
            hexdata = ''
            if len(parts) > 3 and not parts[3].startswith('#'):
                hexdata = parts[3]
            raw = bytes.fromhex(hexdata)
            if np.dtype(dt).kind == 'S':
                value = raw.decode('utf-8', errors='replace')
                if decode_json and value.startswith('json://'):
                    value = json.loads(value[7:], cls=JSONDecoder)
            else:
                arr = np.frombuffer(raw, dtype=np.dtype(dt))
                value = arr[0] if int(nmemb) == 1 else arr.copy()
            out[name] = value
    return out


# ----------------------------------------------------------------- write

class BigFileWriter(object):
    """Writer producing the real bigfile directory layout."""

    def __init__(self, path, create=True):
        self.path = path
        if create:
            os.makedirs(path, exist_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass

    def write(self, dataset, array, attrs=None, nfile=None,
              dtype_str=None):
        """Write one column as a block. Arrays of ndim > 2 are stored
        flattened per row (NMEMB = prod of the item shape); callers
        persisting full meshes record the logical shape in an
        ``ndarray.shape`` attr (the reference's convention,
        base/mesh.py:393-397). ``dtype_str`` overrides the header's
        DTYPE (a bfloat16 block: its raw bits under
        ``utils.BF16_BIGFILE_DTYPE``)."""
        array = np.ascontiguousarray(array)
        if array.dtype.byteorder == '>':
            array = array.astype(array.dtype.newbyteorder('<'))
        size = len(array)
        nmemb = int(np.prod(array.shape[1:], dtype=int))
        flat = array.reshape(size, nmemb) if array.ndim > 1 else array
        if nfile is None:
            # the reference targets ~32M rows per physical file
            nfile = max(1, (size + (1 << 25) - 1) >> 25)

        bdir = os.path.join(self.path, dataset)
        os.makedirs(bdir, exist_ok=True)
        bounds = _file_bounds(size, nfile)
        entries = []
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            # the rows as bytes without a copy (flat is contiguous)
            raw = flat[lo:hi].reshape(-1).view(np.uint8)
            with open(os.path.join(bdir, '%06X' % i), 'wb') as ff:
                ff.write(raw.data)
            entries.append((i, hi - lo, _checksum(raw)))
        with open(os.path.join(bdir, _HEADER), 'w') as ff:
            ff.write('DTYPE: %s\n' % (dtype_str or _norm_dtype(array.dtype)))
            ff.write('NMEMB: %d\n' % nmemb)
            ff.write('NFILE: %d\n' % nfile)
            for i, n, cks in entries:
                ff.write('%06X: %d : %d\n' % (i, n, cks))
        if attrs:
            self.write_attrs(dataset, attrs, merge=True)

    def write_attrs(self, dataset, attrs, merge=False):
        """Write (or merge into) a block's attribute set; creates a
        zero-sized block if the dataset does not exist yet (bigfile
        header blocks are normally empty blocks carrying attrs)."""
        bdir = os.path.join(self.path, dataset)
        if not os.path.exists(os.path.join(bdir, _HEADER)):
            self.write(dataset, np.empty(0, dtype='i8'), nfile=0)
        out = {}
        if merge:
            out = read_attrs_file(bdir, decode_json=False)
        out.update(attrs)
        write_attrs_file(bdir, out)


# ------------------------------------------------------------------ read

class BigFileDataset(object):
    """A single on-disk block (column)."""

    def __init__(self, root, name):
        self.dir = os.path.join(root, name)
        self.name = name
        fn = os.path.join(self.dir, _HEADER)
        fields = {}
        entries = []
        with open(fn) as ff:
            for line in ff:
                if ':' not in line:
                    continue
                key, _, rest = line.partition(':')
                key = key.strip()
                if key in ('DTYPE', 'NMEMB', 'NFILE'):
                    fields[key] = rest.strip()
                else:
                    parts = rest.split(':')
                    cks = int(parts[1]) if len(parts) > 1 \
                        and parts[1].strip() else None
                    entries.append((int(key, 16), int(parts[0]), cks))
        self.dtype = np.dtype(fields['DTYPE'])
        self.nmemb = int(fields.get('NMEMB', 1))
        self.nfile = int(fields.get('NFILE', 0))
        sizes = np.zeros(self.nfile, dtype='i8')
        # header checksums, verified lazily per physical file on the
        # first read that touches it (None = writer recorded none)
        self.checksums = {}
        self._verified = set()
        for i, n, cks in entries:
            sizes[i] = n
            self.checksums[i] = cks
        self.bounds = np.concatenate([[0], np.cumsum(sizes)])
        n = int(self.bounds[-1])
        self.shape = (n,) if self.nmemb == 1 else (n, self.nmemb)
        self.attrs = read_attrs_file(self.dir)

    @property
    def size(self):
        return self.shape[0]

    def _verify_files(self, start, stop):
        """Checksum every not-yet-verified physical file overlapping
        the record range [start, stop) against its header entry.  One
        full-file read per file per process lifetime — the price of
        knowing the bytes about to flow into a paint are the bytes the
        writer committed."""
        if not _verify_enabled():
            return
        for i in range(self.nfile):
            lo, hi = self.bounds[i], self.bounds[i + 1]
            if i in self._verified or hi <= start or lo >= stop:
                continue
            cks = self.checksums.get(i)
            if not cks:
                # None: writer recorded no checksum field.  0: several
                # foreign writers emit a literal ': 0' placeholder
                # without summing; a genuinely all-zero file passes a
                # 0 check trivially, so skipping loses no coverage.
                self._verified.add(i)
                continue
            fn = os.path.join(self.dir, '%06X' % i)
            with open(fn, 'rb') as ff:
                got = _checksum(ff.read())
            if got != cks:
                raise ChecksumMismatch(fn, self.name, cks, got)
            self._verified.add(i)

    def read(self, start, stop, native=True):
        """Records [start, stop), after the checksums of the files they
        touch: through the native threaded reader, or with
        ``native=False`` through a numpy loop over the part files."""
        if not (0 <= start <= stop <= self.size):
            raise IndexError(
                "record range [%d, %d) outside block of size %d"
                % (start, stop, self.size))
        self._verify_files(start, stop)
        itemshape = self.shape[1:]
        nper = self.nmemb
        if native:
            from . import _native
            got = _native.read_block(self.dir, self.bounds, self.dtype,
                                     nper, start, stop)
            return got.reshape((stop - start,) + itemshape)
        out = np.empty((stop - start,) + itemshape, dtype=self.dtype)
        for i in range(self.nfile):
            lo, hi = self.bounds[i], self.bounds[i + 1]
            s = max(start, lo)
            e = min(stop, hi)
            if s >= e:
                continue
            fn = os.path.join(self.dir, '%06X' % i)
            with open(fn, 'rb') as ff:
                ff.seek((s - lo) * self.dtype.itemsize * nper)
                data = np.fromfile(ff, dtype=self.dtype,
                                   count=(e - s) * nper)
            out[s - start:e - start] = data.reshape((e - s,) + itemshape)
        return out


def _is_block(bdir):
    return os.path.isdir(bdir) and \
        os.path.exists(os.path.join(bdir, _HEADER))


class BigFile(FileType):
    """Reader exposing the FileType contract over a bigfile directory
    (reference: nbodykit/io/bigfile.py:16 with ``dataset``, ``header``
    and ``exclude`` semantics)."""

    def __init__(self, path, exclude=None, header='Header', dataset='./'):
        self.path = path
        self.dataset = dataset.rstrip('/')
        root = os.path.join(path, self.dataset) if self.dataset not in \
            ('.', '') else path
        self.root = root

        if exclude is None:
            exclude = [header, 'Header']
        self._blocks = {}
        for name in sorted(os.listdir(root)):
            bdir = os.path.join(root, name)
            if not _is_block(bdir) or name in exclude:
                continue
            b = BigFileDataset(root, name)
            if b.size:
                self._blocks[name] = b
        blocks = list(self._blocks)
        if not blocks:
            raise ValueError("no data blocks found under %s" % root)
        sizes = {name: b.size for name, b in self._blocks.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError("column size mismatch: %s" % sizes)
        self.size = next(iter(sizes.values()))

        dt = []
        for name in blocks:
            b = self._blocks[name]
            itemshape = b.shape[1:]
            dt.append((name, b.dtype, itemshape) if itemshape
                      else (name, b.dtype))
        self.dtype = np.dtype(dt)

        # attrs from the header block (searched relative to the file
        # root, like the reference)
        self.attrs = {}
        for hdr in [header, 'Header']:
            bdir = os.path.join(path, hdr)
            if os.path.isdir(bdir):
                self.attrs = read_attrs_file(bdir)
                break

    def read(self, columns, start, stop, step=1):
        out = self._empty(columns, (stop - start + step - 1) // step)
        for col in columns:
            out[col] = self._blocks[col].read(start, stop)[::step]
        return out
