"""BinnedStatistic: an xarray-like container for binned results.

A copy of the JAX package's numpy-only ``binned_statistic.py``; the port
keeps its own so that it imports nothing of that package.

Re-implementation of the capability surface of the reference's
``nbodykit/binned_statistic.py:60`` (rank-replicated small data; numpy
only — no device arrays live here). Algorithms produce one of these per
measurement; it supports coordinate selection (``sel``), fancy indexing
(``take``), re-binning (``reindex``), averaging, squeezing, renaming,
and JSON round-trips.

Internally variables live in a dict of plain numpy arrays (not a
structured array as in the reference); the public API accepts and
exposes structured arrays for compatibility.
"""

import json

import numpy as np

from .utils import JSONEncoder, JSONDecoder


def _rebin_array(arr, new_shape, weights=None, op=np.nanmean):
    """Re-bin ``arr`` to ``new_shape`` (each new axis size must divide the
    old one), applying ``op`` over the collapsed sub-blocks, optionally
    weighted. Fresh implementation of the capability of the reference's
    ``bin_ndarray`` (binned_statistic.py:3)."""
    if arr.ndim != len(new_shape):
        raise ValueError("dimension mismatch in rebinning")
    pairs = []
    for new, old in zip(new_shape, arr.shape):
        if old % new:
            raise ValueError("new shape must evenly divide old shape")
        pairs.extend([new, old // new])
    a = arr.reshape(pairs)
    if weights is not None:
        w = weights.reshape(pairs)
    # collapse every second axis, from the back
    for ax in range(len(new_shape) - 1, -1, -1):
        axis = 2 * ax + 1
        if weights is not None:
            num = np.nansum(a * w, axis=axis)
            den = np.nansum(w, axis=axis)
            with np.errstate(invalid='ignore', divide='ignore'):
                a = num / den
            w = None  # weights only apply once; collapse them too
            weights = None
        else:
            a = op(a, axis=axis)
    return a


class BinnedStatistic(object):
    """Statistics binned on a fixed coordinate grid, e.g. P(k, mu).

    Parameters
    ----------
    dims : list of str — coordinate dimension names
    edges : list of arrays — bin edges per dimension
    data : structured numpy array (reference-compatible) or dict of
        arrays; shape must match the grid implied by ``edges``
    fields_to_sum : variables summed (not averaged) when re-binning
    coords : optional list of explicit bin centers (else edge midpoints)
    **kwargs : stored in :attr:`attrs`
    """

    def __init__(self, dims, edges, data, fields_to_sum=[], coords=None,
                 **kwargs):
        if len(dims) != len(edges):
            raise ValueError("size mismatch between `dims` and `edges`")

        shape = tuple(len(e) - 1 for e in edges)

        if isinstance(data, np.ndarray) and data.dtype.names is not None:
            variables = {name: np.array(data[name]) for name in
                         data.dtype.names}
        elif isinstance(data, dict):
            variables = {k: np.asarray(v) for k, v in data.items()}
        else:
            raise TypeError("'data' should be a structured array or a "
                            "dict of arrays")

        for name, v in variables.items():
            if v.shape != shape:
                raise ValueError(
                    "`edges` imply shape %s but variable %r has shape %s"
                    % (shape, name, v.shape))

        self.dims = list(dims)
        self.edges = {d: np.asarray(e) for d, e in zip(self.dims, edges)}
        self.coords = {}
        for i, d in enumerate(self.dims):
            if coords is not None and coords[i] is not None:
                self.coords[d] = np.array(coords[i])
            else:
                e = self.edges[d]
                self.coords[d] = 0.5 * (e[1:] + e[:-1])

        self._vars = variables
        self._fields_to_sum = list(fields_to_sum)
        self.attrs = dict(kwargs)

    # -- basic properties -------------------------------------------------

    @property
    def shape(self):
        return tuple(len(self.coords[d]) for d in self.dims)

    @property
    def variables(self):
        return list(self._vars)

    @property
    def data(self):
        """The variables as a structured numpy array (reference-style
        view; computed on demand)."""
        dtype = np.dtype([(name, v.dtype.str)
                          for name, v in self._vars.items()])
        out = np.empty(self.shape, dtype=dtype)
        for name, v in self._vars.items():
            out[name] = v
        return out

    @property
    def mask(self):
        """True where any variable is non-finite."""
        m = np.zeros(self.shape, dtype=bool)
        for v in self._vars.values():
            if np.issubdtype(v.dtype, np.number):
                m |= ~np.isfinite(v)
        return m

    # -- dunder sugar -----------------------------------------------------

    def __str__(self):
        dims = "(" + ", ".join('%s: %d' % (d, n)
                               for d, n in zip(self.dims, self.shape)) + ")"
        if len(self.variables) < 5:
            return "<%s: dims: %s, variables: %s>" % (
                self.__class__.__name__, dims, str(tuple(self.variables)))
        return "<%s: dims: %s, variables: %d total>" % (
            self.__class__.__name__, dims, len(self.variables))

    __repr__ = __str__

    def __iter__(self):
        return iter(self.variables)

    def __contains__(self, key):
        return key in self._vars

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if value.shape != self.shape:
            raise ValueError("shape mismatch adding variable %r" % key)
        self._vars[key] = value

    def __getitem__(self, key):
        # variable access
        if isinstance(key, str):
            if key in self._vars:
                return self._vars[key]
            raise KeyError("no variable named %r" % key)
        # list/tuple of variables -> subset copy
        if isinstance(key, (list, tuple)) and \
                all(isinstance(k, str) for k in key):
            missing = [k for k in key if k not in self._vars]
            if missing:
                raise KeyError("no variables named %s" % missing)
            new = self.copy()
            new._vars = {k: self._vars[k].copy() for k in key}
            return new
        # positional slicing (reference Dataset semantics: an integer
        # index SQUEEZES its dimension, a list keeps it, and selecting
        # a single element — every dim squeezed — is an error)
        key = (key,) if not isinstance(key, tuple) else key
        if len(key) > len(self.dims):
            raise IndexError("too many indices")
        indices = []
        squeeze_dims = []
        for i, d in enumerate(self.dims):
            n = self.shape[i]
            if i < len(key):
                k = key[i]
                if isinstance(k, (int, np.integer)):
                    idx = np.array([int(k) % n])
                    squeeze_dims.append(d)
                elif isinstance(k, slice):
                    idx = np.arange(n)[k]
                else:
                    idx = np.arange(n)[np.asarray(k)]
            else:
                idx = np.arange(n)
            indices.append(idx)
        if len(squeeze_dims) == len(self.dims):
            raise IndexError(
                "cannot access a single element; use [var] access plus "
                "numpy indexing instead")
        out = self._take_indices(indices)
        for d in squeeze_dims:
            out = out.squeeze(d)
        return out

    # -- construction helpers ---------------------------------------------

    def copy(self, cls=None):
        if cls is None:
            cls = self.__class__
        elif not issubclass(cls, BinnedStatistic):
            raise TypeError("cls must be a subclass of BinnedStatistic")
        new = object.__new__(cls)
        new.dims = list(self.dims)
        new.edges = {d: e.copy() for d, e in self.edges.items()}
        new.coords = {d: c.copy() for d, c in self.coords.items()}
        new._vars = {k: v.copy() for k, v in self._vars.items()}
        new._fields_to_sum = list(self._fields_to_sum)
        new.attrs = self.attrs.copy()
        return new

    def rename_variable(self, old_name, new_name):
        """Rename a variable IN-PLACE (reference semantics,
        binned_statistic.py 'performed in-place'); returns None."""
        if old_name not in self._vars:
            raise ValueError("no variable named %r" % old_name)
        self._vars = {(new_name if k == old_name else k): v
                      for k, v in self._vars.items()}

    def _take_indices(self, indices):
        """New instance keeping the given per-dimension index arrays
        (contiguity assumed for edges: the edge array keeps the spans
        of the selected bins)."""
        new = self.copy()
        for i, d in enumerate(self.dims):
            idx = np.asarray(indices[i])
            if len(idx) > 0:
                eidx = np.concatenate([idx, [idx[-1] + 1]])
            else:
                eidx = np.array([0])
            new.edges[d] = self.edges[d][eidx]
            new.coords[d] = self.coords[d][idx] if len(idx) else \
                self.coords[d][:0]
        for name in list(new._vars):
            v = self._vars[name]
            for ax, idx in enumerate(indices):
                v = np.take(v, idx, axis=ax)
            new._vars[name] = v
        return new

    # -- selection --------------------------------------------------------

    def _get_index(self, dim, val, method=None):
        coords = self.coords[dim]
        if method == 'nearest':
            return int(np.abs(coords - val).argmin())
        i = np.where(coords == val)[0]
        if len(i) == 0:
            raise IndexError("value %s not found in dimension %r; try "
                             "method='nearest'" % (val, dim))
        return int(i[0])

    def sel(self, method=None, **indexers):
        """Coordinate-value based selection; scalar selections squeeze
        the corresponding dimension (reference semantics,
        binned_statistic.py:597)."""
        indices = []
        squeeze_dims = []
        for i, d in enumerate(self.dims):
            n = self.shape[i]
            if d not in indexers:
                indices.append(np.arange(n))
                continue
            val = indexers.pop(d)
            if isinstance(val, slice):
                start = 0 if val.start is None else self._get_index(
                    d, val.start, method='nearest')
                stop = n - 1 if val.stop is None else self._get_index(
                    d, val.stop, method='nearest')
                indices.append(np.arange(start, stop + 1))
            elif np.isscalar(val):
                indices.append(np.array([self._get_index(d, val, method)]))
                squeeze_dims.append(d)
            else:
                indices.append(np.array(
                    [self._get_index(d, v, method) for v in val]))
        if indexers:
            raise ValueError("unknown dimensions in sel: %s"
                             % list(indexers))
        out = self._take_indices(indices)
        for d in squeeze_dims:
            if len(out.dims) > 1:
                out = out.squeeze(dim=d)
        return out

    def take(self, *masks, **indices):
        """Index-based selection; see reference binned_statistic.py:664.
        Accepts grid-shaped boolean masks (kept where True everywhere
        along the other axes) and per-dimension index arrays / boolean
        vectors."""
        keep = [np.ones(n, dtype=bool) for n in self.shape]
        if masks:
            total = np.ones(self.shape, dtype=bool)
            for m in masks:
                total &= m
            for i in range(len(self.dims)):
                other = tuple(j for j in range(len(self.dims)) if j != i)
                keep[i] &= total.all(axis=other) if other else total
        for d, index in indices.items():
            i = self.dims.index(d)
            index = np.asarray(index)
            if index.dtype == bool:
                keep[i] &= index
            else:
                m = np.zeros(self.shape[i], dtype=bool)
                m[index] = True
                keep[i] &= m
        return self._take_indices([k.nonzero()[0] for k in keep])

    def squeeze(self, dim=None):
        """Drop a length-one dimension (reference
        binned_statistic.py:745)."""
        if dim is None:
            cands = [d for d in self.dims if len(self.coords[d]) == 1]
            if not cands:
                raise ValueError("no length-one dimension to squeeze")
            if len(cands) > 1:
                raise ValueError("multiple squeezable dimensions; specify")
            dim = cands[0]
        if dim not in self.dims:
            raise ValueError("%r is not a dimension" % dim)
        if len(self.coords[dim]) != 1:
            raise ValueError("dimension %r does not have length one" % dim)
        if len(self.dims) == 1:
            raise ValueError("cannot squeeze the only remaining axis")
        i = self.dims.index(dim)
        new = self.copy()
        new.dims.pop(i)
        new.edges.pop(dim)
        new.coords.pop(dim)
        new._vars = {k: v.squeeze(axis=i) for k, v in new._vars.items()}
        return new

    # -- re-binning -------------------------------------------------------

    def average(self, dim, **kwargs):
        """Average all variables over one dimension."""
        spacing = self.edges[dim][-1] - self.edges[dim][0]
        out = self.reindex(dim, spacing, **kwargs)
        return out.sel(**{dim: out.coords[dim][0]})

    def reindex(self, dim, spacing, weights=None, force=True,
                return_spacing=False, fields_to_sum=[]):
        """Coarsen dimension ``dim`` to (approximately) ``spacing`` by
        merging an integral number of adjacent bins (reference semantics,
        binned_statistic.py:829): variables are nan-averaged, optionally
        ``weights``-weighted; ``fields_to_sum`` (plus the instance's) are
        summed."""
        i = self.dims.index(dim)
        fields_to_sum = list(fields_to_sum) + self._fields_to_sum

        old_spacings = np.diff(self.coords[dim])
        old_spacing = old_spacings[0]

        factor = int(np.round(spacing / old_spacing))
        if not factor:
            raise ValueError("new spacing must exceed the original %.2e"
                             % old_spacing)
        if factor == 1:
            raise ValueError("closest new binning equals current binning")
        if not np.allclose(old_spacing * factor, spacing) and not force:
            raise ValueError("with force=False the new spacing must be an "
                             "integral multiple of the old")

        if isinstance(weights, str):
            if weights not in self._vars:
                raise ValueError("cannot weight by %r; no such variable"
                                 % weights)
            weights = self._vars[weights]

        leftover = self.shape[i] % factor
        if leftover and not force:
            raise ValueError("%d leftover bins at spacing %.2e; use "
                             "force=True to drop them"
                             % (leftover, old_spacing * factor))

        new = self.copy()
        sl = [slice(None)] * len(self.dims)
        if leftover:
            sl[i] = slice(None, -leftover)
        edges = self.edges[dim]
        if leftover:
            edges = edges[:-leftover]
        nnew = (self.shape[i] - leftover) // factor
        new_shape = list(self.shape)
        new_shape[i] = nnew
        new_edges = np.linspace(edges[0], edges[-1], nnew + 1)

        for name, v in self._vars.items():
            vv = v[tuple(sl)]
            if name in fields_to_sum:
                new._vars[name] = _rebin_array(vv, new_shape, op=np.nansum)
            elif weights is not None:
                ww = weights[tuple(sl)]
                new._vars[name] = _rebin_array(vv, new_shape, weights=ww)
            else:
                new._vars[name] = _rebin_array(vv, new_shape)
        new.edges[dim] = new_edges
        new.coords[dim] = 0.5 * (new_edges[1:] + new_edges[:-1])
        return (new, old_spacing * factor) if return_spacing else new

    # -- persistence ------------------------------------------------------

    def __getstate__(self):
        return dict(dims=self.dims,
                    edges=[self.edges[d] for d in self.dims],
                    coords=[self.coords[d] for d in self.dims],
                    data=self.data,
                    attrs=self.attrs)

    def __setstate__(self, state):
        self.__init__(state['dims'], state['edges'], state['data'],
                      coords=state.get('coords'))
        self.attrs.update(state.get('attrs', {}))

    @classmethod
    def from_state(cls, state):
        obj = cls(dims=state['dims'], edges=state['edges'],
                  data=state['data'], coords=state.get('coords'))
        obj.attrs.update(state.get('attrs', {}))
        return obj

    def to_json(self, filename):
        """Write to JSON (numpy-aware encoding; round-trips through
        :meth:`from_json`)."""
        state = self.__getstate__()
        with open(filename, 'w') as ff:
            json.dump({'data': state}, ff, cls=JSONEncoder)

    @classmethod
    def from_json(cls, filename, key='data', dims=None, edges=None,
                  **kwargs):
        """Load from JSON. Accepts both our wrapped layout
        (``{'data': {dims, edges, data, ...}}``, written by
        :meth:`to_json`) and the reference's flat layout where ``key``
        names the structured data array and ``dims``/``edges``/
        ``coords``/``attrs`` are top-level siblings (written by
        nbodykit's ``to_json``, read at reference
        binned_statistic.py:445-504) — archived nbodykit results load
        unchanged."""
        with open(filename, 'r') as ff:
            state = json.load(ff, cls=JSONDecoder)
        if key in state:
            inner = state[key]
            if isinstance(inner, dict) and 'data' in inner:
                # our wrapped full-state layout
                obj = cls.from_state(inner)
                obj.attrs.update(kwargs)
                return obj
            # reference flat layout: `inner` is the data array itself
            dims = state.get('dims', dims)
            edges = state.get('edges', edges)
            if dims is None:
                raise ValueError(
                    "no `dims` in JSON file; pass dims= explicitly")
            if edges is None:
                raise ValueError(
                    "no `edges` in JSON file; pass edges= explicitly")
            obj = cls(dims=dims, edges=edges, data=inner,
                      coords=state.get('coords'))
            obj.attrs.update(state.get('attrs', {}))
            obj.attrs.update(kwargs)
            return obj
        obj = cls.from_state(state)
        obj.attrs.update(kwargs)
        return obj

    @classmethod
    def from_plaintext(cls, dims, filename, **kwargs):
        """Initialize from the deprecated nbodykit 0.1.x ASCII storage
        (reference binned_statistic.py:505-551; readers :957 and
        :1032). Kept for loading legacy measurement files."""
        import warnings
        warnings.warn(
            "storage of BinnedStatistic objects as ASCII plaintext "
            "files is deprecated; see BinnedStatistic.from_json",
            FutureWarning, stacklevel=2)
        if not isinstance(dims, (tuple, list)):
            raise TypeError("`dims` should be a list or tuple of "
                            "strings")
        try:
            if len(dims) == 1:
                data, meta = _read_1d_plaintext(filename)
            elif len(dims) == 2:
                data, meta = _read_2d_plaintext(filename)
            else:
                raise ValueError("plaintext storage supports 1 or 2 "
                                 "dimensions")
        except Exception as e:
            raise ValueError(
                "unable to read plaintext file, perhaps the dimension "
                "of the file does not match the passed `dims`;\n"
                "exception: %s" % str(e))
        edges = meta.pop('edges', None)
        if edges is None:
            raise ValueError("plaintext file does not include `edges`; "
                             "cannot be loaded into a BinnedStatistic")
        if len(dims) == 1:
            edges = [edges]
            columns = meta.pop('columns', None)
            if columns is None:
                raise ValueError("1D plaintext file must name its "
                                 "columns in a leading '#' line")
            d = {name: data[:, i] for i, name in enumerate(columns)}
        else:
            d = {name: data[name] for name in data.dtype.names}
        meta.update(kwargs)
        return cls(dims, edges, d, **meta)


# ---------------------------------------------------------------------------
# deprecated nbodykit 0.1.x plaintext measurement formats
# (reference binned_statistic.py:957-1139)

def _cast_meta(name, value, castname, metadata):
    import builtins
    if hasattr(builtins, castname):
        metadata[name] = getattr(builtins, castname)(value)
    elif hasattr(np, castname):
        metadata[name] = getattr(np, castname)(value)
    else:
        raise TypeError("metadata must have builtin or numpy type")


def _read_1d_plaintext(filename):
    """1D format: '# col names' first line, data rows, then '# edges N'
    followed by N '#<float>' lines, then optionally '# metadata N'
    followed by N '# name value type' lines."""
    data = []
    metadata = {}
    with open(filename, 'r') as ff:
        lines = ff.readlines()
    cur = 0
    if lines and lines[0][0] == '#':
        metadata['columns'] = lines[0][1:].split()
        cur = 1
    while cur < len(lines):
        line = lines[cur]
        if not line.strip():
            cur += 1
            continue
        if line[0] != '#':
            data.append([float(l) for l in line.split()])
            cur += 1
            continue
        body = line[1:]
        if 'edges' in body:
            N = int(body.split()[-1])
            metadata['edges'] = np.array(
                [float(l[1:]) for l in lines[cur + 1:cur + 1 + N]])
            cur += 1 + N
            continue
        if 'metadata' in body:
            N = int(body.split()[-1])
            for meta in lines[cur + 1:cur + 1 + N]:
                name, value, castname = meta[1:].split()
                _cast_meta(name, value, castname, metadata)
            cur += 1 + N
            continue
        cur += 1
    return np.asarray(data), metadata


def _read_2d_plaintext(filename):
    """2D format: 'Nx Ny' first line, column names second, Nx*Ny data
    rows, then two edge blocks each headed by a line ending in its
    length, then optional metadata rows 'name value type'."""
    metadata = {}
    d = {}
    with open(filename, 'r') as ff:
        Nx, Ny = [int(l) for l in ff.readline().split()]
        N = Nx * Ny
        columns = ff.readline().split()
        lines = ff.readlines()
    data = np.array([float(l) for line in lines[:N]
                     for l in line.split()])
    data = data.reshape((Nx, Ny, -1))
    i = 0
    while i < len(columns):
        name = columns[i]
        nextname = columns[i + 1] if i < len(columns) - 1 else ''
        if name.endswith('.real') and nextname.endswith('.imag'):
            name = name[:-len('.real')]
            d[name] = data[..., i] + 1j * data[..., i + 1]
            i += 2
        else:
            d[name] = data[..., i]
            i += 1
    dtypes = np.dtype([(name, d[name].dtype) for name in d])
    out = np.empty(data.shape[:2], dtype=dtypes)
    for name in d:
        out[name] = d[name]

    edges = []
    l1 = int(lines[N].split()[-1])
    N = N + 1
    edges.append(np.array([float(line) for line in lines[N:N + l1]]))
    l2 = int(lines[N + l1].split()[-1])
    N = N + l1 + 1
    edges.append(np.array([float(line) for line in lines[N:N + l2]]))
    metadata['edges'] = edges

    if len(lines) > N + l2:
        n_meta = int(lines[N + l2].split()[-1])
        N = N + l2 + 1
        for line in lines[N:N + n_meta]:
            name, value, castname = line.split()
            _cast_meta(name, value, castname, metadata)
    return out, metadata
