"""FITSFile: FITS binary-table reads.

A copy of ``nbodykit_tpu/io/fits.py`` (numpy only): the port keeps its
own, so it imports nothing of the JAX package.

Reference: ``nbodykit/io/fits.py:8`` (fitsio, a cfitsio binding).
Neither fitsio nor astropy is guaranteed in this environment, so a
built-in parser handles the standard numeric BINTABLE layout natively
(FITS is 2880-byte header blocks of 80-char cards + a big-endian
record array — no external dependency needed for the common case).
astropy is preferred when importable (variable-length arrays, scaling,
compressed HDUs).
"""

import numpy as np

from .base import FileType

# TFORMn letter -> numpy big-endian dtype
# disk representation per TFORM letter; 'L' is the ASCII bytes 'T'/'F'
# and is exposed as bool after an explicit compare (a raw view would
# read every 'F' (0x46, nonzero) as True)
_TFORM = {'L': 'u1', 'B': 'u1', 'I': '>i2', 'J': '>i4', 'K': '>i8',
          'E': '>f4', 'D': '>f8', 'A': 'S'}
_BLOCK = 2880


def _read_header(ff):
    """Parse one FITS header (cards until END, block-aligned); returns
    (dict, data_offset_after_header)."""
    cards = {}
    while True:
        block = ff.read(_BLOCK)
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode('ascii', errors='replace')
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if not key or card[8] != '=':
                continue
            raw = card[10:]
            if raw.lstrip().startswith("'"):
                # quoted string: value ends at the first un-doubled
                # quote; '/' inside is part of the value, '' escapes
                body = raw.lstrip()[1:]
                chars, j = [], 0
                while j < len(body):
                    if body[j] == "'":
                        if j + 1 < len(body) and body[j + 1] == "'":
                            chars.append("'")
                            j += 2
                            continue
                        break
                    chars.append(body[j])
                    j += 1
                cards[key] = ''.join(chars).strip()
                continue
            val = raw.split('/')[0].strip()
            if val in ('T', 'F'):
                cards[key] = val == 'T'
            else:
                try:
                    cards[key] = int(val)
                except ValueError:
                    try:
                        cards[key] = float(val)
                    except ValueError:
                        cards[key] = val
        if done:
            return cards, ff.tell()


def _parse_tform(tform):
    """'1D', 'E', '3J', '10A' -> (repeat, letter)."""
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    letter = tform[i:i + 1]
    if letter not in _TFORM:
        raise ValueError("unsupported TFORM %r" % tform)
    return repeat, letter


class _NativeFits(object):
    """Minimal native BINTABLE backend: walks HDUs, exposes the first
    (or requested) binary table as an on-disk big-endian recarray."""

    def __init__(self, path, ext=None):
        self.path = path
        fsize = self._file_size_of(path)
        with open(path, 'rb') as ff:
            header, off = _read_header(ff)   # primary HDU
            if not header.get('SIMPLE', False):
                raise ValueError("not a FITS file (no SIMPLE card)")
            hdu_index = 0
            data_size = self._data_bytes(header)
            while True:
                nxt = off + self._padded(data_size)
                if nxt >= fsize:
                    raise ValueError("no binary table HDU found")
                ff.seek(nxt)
                header, off = _read_header(ff)
                hdu_index += 1
                data_size = self._data_bytes(header)
                if header.get('XTENSION') == 'BINTABLE' and \
                        (ext is None or ext == hdu_index):
                    break
        self.ext = hdu_index
        self.header = header
        self.data_start = off
        self.nrows = int(header['NAXIS2'])
        self.rowbytes = int(header['NAXIS1'])

        fields = []
        self.logical_cols = set()
        for i in range(1, int(header['TFIELDS']) + 1):
            name = str(header.get('TTYPE%d' % i, 'col%d' % i)).strip()
            repeat, letter = _parse_tform(str(header['TFORM%d' % i]))
            if letter == 'L':
                self.logical_cols.add(name)
            if letter == 'A':
                fields.append((name, 'S%d' % repeat))
            elif repeat == 1:
                fields.append((name, _TFORM[letter]))
            else:
                fields.append((name, _TFORM[letter], (repeat,)))
        self.dtype_disk = np.dtype(fields)
        if self.dtype_disk.itemsize != self.rowbytes:
            raise ValueError(
                "BINTABLE row size %d != dtype size %d (unsupported "
                "TFORM layout)" % (self.rowbytes,
                                   self.dtype_disk.itemsize))

    @staticmethod
    def _file_size_of(path):
        import os
        return os.path.getsize(path)

    @staticmethod
    def _padded(n):
        return ((n + _BLOCK - 1) // _BLOCK) * _BLOCK

    @staticmethod
    def _data_bytes(header):
        if header.get('NAXIS', 0) == 0:
            return 0
        naxes = [int(header.get('NAXIS%d' % i, 0))
                 for i in range(1, int(header['NAXIS']) + 1)]
        # random-groups convention: NAXIS1 == 0 means "no primary
        # array"; the group size is the product of the REMAINING axes
        if naxes and naxes[0] == 0 and len(naxes) > 1:
            naxes = naxes[1:]
        n = 1
        for a in naxes:
            n *= a
        # FITS standard sizing: |BITPIX|/8 * GCOUNT * (PCOUNT + prod(NAXIS))
        # — PCOUNT bytes scale with BITPIX/GCOUNT too (random-groups HDUs)
        return abs(int(header.get('BITPIX', 8))) // 8 \
            * int(header.get('GCOUNT', 1)) \
            * (int(header.get('PCOUNT', 0)) + n)

    def read_rows(self, start, stop):
        if not (0 <= start <= stop <= self.nrows):
            raise IndexError(
                "row range [%d, %d) outside table of %d rows"
                % (start, stop, self.nrows))
        with open(self.path, 'rb') as ff:
            ff.seek(self.data_start + start * self.rowbytes)
            raw = ff.read((stop - start) * self.rowbytes)
        return np.frombuffer(raw, dtype=self.dtype_disk)


class FITSFile(FileType):
    """FITS binary table reader (ext selects the HDU). Uses astropy
    when importable, else the built-in native BINTABLE parser."""

    def __init__(self, path, ext=None):
        self.path = path
        try:
            from astropy.io import fits
            self._backend = 'astropy'
        except ImportError:
            self._backend = 'native'

        if self._backend == 'astropy':
            with fits.open(path) as hdus:
                if ext is None:
                    for i, hdu in enumerate(hdus):
                        if getattr(hdu, 'data', None) is not None and \
                                getattr(hdu, 'columns', None) is not None:
                            ext = i
                            break
                if ext is None:
                    raise ValueError("no binary table HDU found")
                self.ext = ext
                data = hdus[ext].data
                self.size = len(data)
                self.dtype = data.dtype
                self.attrs = dict(hdus[ext].header)
        else:
            nat = _NativeFits(path, ext=ext)
            self._native = nat
            self.ext = nat.ext
            self.size = nat.nrows
            # expose native-endian dtypes; logical columns read back
            # as bool
            def _expose(n):
                dt = nat.dtype_disk[n].newbyteorder('=')
                if n in nat.logical_cols:
                    return np.dtype((np.bool_, dt.shape)) \
                        if dt.shape else np.dtype(np.bool_)
                return dt
            self.dtype = np.dtype([
                (n, _expose(n)) for n in nat.dtype_disk.names])
            self.attrs = dict(nat.header)

    def read(self, columns, start, stop, step=1):
        out = self._empty(columns, len(range(start, stop, step)))
        if self._backend == 'astropy':
            from astropy.io import fits
            with fits.open(self.path) as hdus:
                data = hdus[self.ext].data[start:stop:step]
                for col in columns:
                    out[col] = data[col]
            return out
        idx = np.arange(start, stop, step)
        if idx.size == 0:
            return out
        lo, hi = int(idx.min()), int(idx.max()) + 1
        rows = self._native.read_rows(lo, hi)[idx - lo]
        for col in columns:
            vals = rows[col]
            if self.dtype[col].base == np.dtype(bool):
                vals = vals == ord('T')   # FITS 'L' stores 'T'/'F'
            # .base: astype with a subarray dtype would replicate the
            # trailing axis instead of casting elementwise
            out[col] = vals.astype(self.dtype[col].base)
        return out


def write_bintable(path, cols):
    """Write a minimal standards-conforming single-BINTABLE FITS file
    (2880-byte header blocks of 80-char cards, big-endian records) —
    the writing counterpart of the native parser above, kept in this
    module so the two conventions evolve together. ``cols`` is a list
    of (name, array) pairs; f4/f8/i4/i8 scalars or fixed-width vectors.

    The reference has no FITS writer at all (fitsio/astropy handled
    it); this one covers the catalog-interchange subset.
    """
    def card(key, val, quote=False):
        if quote:
            v = "'%s'" % val
        elif isinstance(val, bool):
            v = 'T' if val else 'F'
        else:
            v = str(val)
        return ('%-8s= %20s' % (key, v)).ljust(80).encode('ascii')

    def block(cards):
        raw = b''.join(cards) + b'END'.ljust(80, b' ')
        return raw.ljust(((len(raw) + 2879) // 2880) * 2880, b' ')

    fields = []
    for name, arr in cols:
        arr = np.asarray(arr)
        letter = {'f8': 'D', 'f4': 'E', 'i4': 'J', 'i8': 'K'}[
            arr.dtype.str[1:]]
        rep = arr.shape[1] if arr.ndim > 1 else 1
        fields.append((name, arr, '%d%s' % (rep, letter)))
    dt = np.dtype([(n, a.dtype.newbyteorder('>'),
                    (a.shape[1],) if a.ndim > 1 else ())
                   for n, a, _ in fields])
    nrows = len(fields[0][1])
    rec = np.zeros(nrows, dtype=dt)
    for n, a, _ in fields:
        rec[n] = a

    with open(path, 'wb') as f:
        f.write(block([card('SIMPLE', True), card('BITPIX', 8),
                       card('NAXIS', 0)]))
        hdr = [card('XTENSION', 'BINTABLE', quote=True),
               card('BITPIX', 8), card('NAXIS', 2),
               card('NAXIS1', dt.itemsize), card('NAXIS2', nrows),
               card('PCOUNT', 0), card('GCOUNT', 1),
               card('TFIELDS', len(fields))]
        for i, (n, _, tform) in enumerate(fields):
            hdr.append(card('TTYPE%d' % (i + 1), n, quote=True))
            hdr.append(card('TFORM%d' % (i + 1), tform, quote=True))
        f.write(block(hdr))
        raw = rec.tobytes()
        f.write(raw.ljust(((len(raw) + 2879) // 2880) * 2880, b'\0'))
