"""Small shared utilities (counterpart of ``nbodykit_tpu/utils.py``).

``working_dtype`` is the identity on dtypes here: PyTorch has the
64-bit float, complex and integer types on the CPU and on the H100,
so no request is demoted. JSON encoding of numpy-laden attrs dicts
keeps the JAX package's format, so a result saved by either package
loads in the other.
"""

import contextlib
import json

import numpy as np

# A callable name -> context manager entered around each named stage of
# a long call (the lognormal mock's build in ``mockmaker`` and
# ``LogNormalCatalog``; the paints, the multipole loop and the binning
# of ``ConvolvedFFTPower``); None times nothing. chip_smoke.py sets it
# to CUDA-event windows.
stage_timer = None


def stage(name):
    """The context of stage ``name`` under :data:`stage_timer`."""
    if stage_timer is None:
        return contextlib.nullcontext()
    return stage_timer(name)


def working_dtype(dt='f8'):
    """The dtype to compute in for a request of ``dt`` (always ``dt``:
    the 64-bit types exist on every device this port runs on)."""
    return np.dtype(dt)


TORCH_DTYPES = {'f4': 'float32', 'f8': 'float64', 'c8': 'complex64',
                'c16': 'complex128', 'i4': 'int32', 'i8': 'int64'}

# the names of the bfloat16 storage request: numpy has no bfloat16 of
# its own, and the JAX package's (ml_dtypes) is named 'bfloat16'
_BF16_NAMES = ('bf16', 'bfloat16', 'torch.bfloat16')


def _is_bf16(dt):
    return str(getattr(dt, 'name', dt)).lower() in _BF16_NAMES


def torch_dtype(dt):
    """The torch dtype of a numpy dtype token ('f4', 'f8', ...), of a
    torch dtype, or of the bfloat16 request ('bf16', 'bfloat16', a JAX
    bfloat16 numpy dtype)."""
    import torch
    if isinstance(dt, torch.dtype):
        return dt
    if _is_bf16(dt):
        return torch.bfloat16
    dt = np.dtype(dt)
    key = dt.kind + str(dt.itemsize)
    try:
        return getattr(torch, TORCH_DTYPES[key])
    except KeyError:
        raise ValueError("unsupported dtype %r" % (dt,))


def mesh_storage_dtype(dt='f4'):
    """A mesh buffer's STORAGE dtype for the token ``dt``:
    ``torch.bfloat16`` for ``'bf16'`` / ``'bfloat16'`` (half the f4
    bytes; numpy has no bfloat16 here), else the numpy dtype of
    :func:`working_dtype`. Compute (weights, transforms, readout) stays
    f32 for a bfloat16 mesh: callers re-widen at once."""
    import torch
    if _is_bf16(dt):
        return torch.bfloat16
    return working_dtype(dt)


def is_narrow_float(dt):
    """True for a float storage dtype narrower than f32 (bfloat16 or
    float16, as a token, a numpy dtype or a torch dtype): the test
    behind every 'compute wide, store narrow' branch."""
    import torch
    if _is_bf16(dt) or dt is torch.float16:
        return True
    if isinstance(dt, torch.dtype):
        return False
    dt = np.dtype(dt)
    return dt.kind in 'fV' and dt.itemsize == 2


# the bigfile DTYPE of a bfloat16 block, as the JAX package writes it
# (the numpy str of ml_dtypes' bfloat16): the raw 16-bit patterns
BF16_BIGFILE_DTYPE = '<V2'


def bf16_from_numpy(array):
    """A CPU ``torch.bfloat16`` tensor holding the bits of a 2-byte
    numpy array: a JAX bfloat16 array (ml_dtypes, ``dtype.name ==
    'bfloat16'``) or the raw '<V2' items of a bigfile block. Bit for
    bit; nothing of ml_dtypes is imported."""
    import torch
    a = np.ascontiguousarray(array)
    if a.dtype.itemsize != 2:
        raise ValueError("bfloat16 items are 2 bytes, got %s" % a.dtype)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def bf16_bits(tensor):
    """The 16-bit patterns of a ``torch.bfloat16`` tensor, as host
    numpy uint16."""
    import torch
    return tensor.detach().contiguous().view(torch.int16).cpu().numpy() \
        .view(np.uint16)


def as_numpy(arr):
    """Fetch a tensor (any device) or array-like to host numpy. A
    bfloat16 tensor comes back as float32, which holds its values
    exactly (numpy has no bfloat16 without the JAX package's
    ``ml_dtypes``)."""
    import torch
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def attrs_to_dict(attrs, prefix=''):
    """``attrs`` with every key prefixed by ``prefix``."""
    return {prefix + k: v for k, v in attrs.items()}


def is_structured_array(arr):
    """True if ``arr`` is a numpy structured array."""
    return getattr(getattr(arr, 'dtype', None), 'names', None) is not None


def split_size_3d(s):
    """Split ``s`` into (a, b, c) with a*b*c == s and a <= b <= c, the
    3-D grid factorization of the JAX package."""
    a = int(s ** (1.0 / 3)) + 1
    while a > 1 and s % a:
        a -= 1
    rest = s // a
    b = int(rest ** 0.5) + 1
    while b > 1 and rest % b:
        b -= 1
    c = rest // b
    return tuple(sorted((a, b, c)))


def get_data_bounds(data, comm=None, selection=None):
    """(min, max) of an array along its first axis, as host numpy;
    with ``selection``, over the selected rows only (an empty selection
    gives the dtype's extremes, as in the JAX package). With a ``comm``
    of several ranks, each passes its rows and every rank gets the
    bounds over all of them."""
    import torch
    arr = torch.as_tensor(data)
    lo = hi = arr
    if selection is not None:
        sel = torch.as_tensor(selection, device=arr.device).bool()
        if arr.is_floating_point():
            big, small = float('inf'), float('-inf')
        else:
            big, small = torch.iinfo(arr.dtype).max, torch.iinfo(arr.dtype).min
        mask = sel[:, None] if arr.ndim > 1 else sel
        lo = torch.where(mask, arr, torch.tensor(big, dtype=arr.dtype,
                                                 device=arr.device))
        hi = torch.where(mask, arr, torch.tensor(small, dtype=arr.dtype,
                                                 device=arr.device))
    lo, hi = torch.amin(lo, dim=0), torch.amax(hi, dim=0)
    if comm is not None and comm.size > 1:
        lo = comm.all_reduce(lo.to(comm.device), 'min')
        hi = comm.all_reduce(hi.to(comm.device), 'max')
    return as_numpy(lo), as_numpy(hi)


def GatherArray(data, comm=None, root=0):
    """Every rank's rows of ``data`` concatenated in rank order, as host
    numpy on rank ``root`` and None on the others (the reference's
    ``utils.GatherArray``). A collective of the comm's ranks; without a
    comm (or on one rank), ``data`` as host numpy."""
    import torch
    if comm is None or comm.size == 1:
        return as_numpy(data)
    t = torch.as_tensor(data).to(comm.device)
    sizes = comm.all_gather(torch.tensor([t.shape[0]], device=comm.device))
    sizes = [int(v) for v in sizes.reshape(-1)]
    mine = comm.rank == root
    got = comm.all_to_all(
        t, [t.shape[0] if d == root else 0 for d in range(comm.size)],
        [sizes[s] if mine else 0 for s in range(comm.size)])
    return as_numpy(got) if mine else None


# the dtypes ScatterArray can send, by code
_SCATTER_DTYPES = ('float64', 'float32', 'float16', 'bfloat16', 'int64',
                   'int32', 'int16', 'int8', 'uint8', 'bool', 'complex128',
                   'complex64')


def ScatterArray(data, comm=None, root=0, counts=None):
    """Rank ``root``'s array cut along its first axis among the ranks
    (the reference's ``utils.ScatterArray``): rank r gets its even rows
    (``parallel.runtime.row_range``), or ``counts[r]`` rows in rank
    order, as a tensor on its device; ranks other than ``root`` may pass
    None. A collective; without a comm, ``data`` as a tensor."""
    import torch
    from .parallel.runtime import row_range
    if comm is None or comm.size == 1:
        return torch.as_tensor(data)
    mine = comm.rank == root
    # the shape and dtype travel from root first
    meta = torch.zeros(9, dtype=torch.int64, device=comm.device)
    if mine:
        t = torch.as_tensor(data).to(comm.device)
        if t.ndim > 7:
            raise ValueError("ScatterArray takes up to 7 dimensions")
        meta[0] = _SCATTER_DTYPES.index(str(t.dtype).split('.')[-1])
        meta[1] = t.ndim
        meta[2:2 + t.ndim] = torch.tensor(t.shape)
    meta = [int(v) for v in comm.broadcast(meta, src=root)]
    dtype = getattr(torch, _SCATTER_DTYPES[meta[0]])
    shape = tuple(meta[2:2 + meta[1]])
    n = shape[0]
    if counts is None:
        counts = [b - a for a, b in (row_range(n, comm.size, r)
                                     for r in range(comm.size))]
    counts = [int(c) for c in counts]
    if len(counts) != comm.size or sum(counts) != n:
        raise ValueError("counts %s do not cut %d rows among %d ranks"
                         % (counts, n, comm.size))
    if not mine:
        t = torch.empty((0,) + shape[1:], dtype=dtype, device=comm.device)
    return comm.all_to_all(
        t, counts if mine else [0] * comm.size,
        [counts[comm.rank] if s == root else 0 for s in range(comm.size)])


class captured_output(object):
    """Context manager capturing Python-level stdout and stderr; yields
    the (stdout, stderr) StringIO buffers."""

    def __enter__(self):
        import io as _io
        import sys
        self._sys = sys
        self._old = (sys.stdout, sys.stderr)
        self.stdout = _io.StringIO()
        self.stderr = _io.StringIO()
        sys.stdout, sys.stderr = self.stdout, self.stderr
        return self.stdout, self.stderr

    def __exit__(self, *exc):
        self._sys.stdout, self._sys.stderr = self._old
        return False


class JSONEncoder(json.JSONEncoder):
    """JSON encoder for numpy scalars/arrays, tensors and complex values:
    arrays become {'__dtype__': ..., '__shape__': ..., '__data__': ...}
    (the JAX package's and the reference's persistence format)."""

    def default(self, obj):
        import torch
        if isinstance(obj, torch.Tensor):
            obj = as_numpy(obj)
        if isinstance(obj, np.generic):
            obj = obj.item()
        if isinstance(obj, complex):
            return {'__complex__': [obj.real, obj.imag]}
        if isinstance(obj, np.ndarray):
            if obj.dtype.kind == 'c':
                data = np.stack([obj.real, obj.imag], axis=-1).tolist()
            elif obj.dtype.kind == 'V':  # structured
                data = {name: self.default(np.ascontiguousarray(obj[name]))
                        for name in obj.dtype.names}
            else:
                data = obj.tolist()
            return {'__dtype__': obj.dtype.str if obj.dtype.kind != 'V'
                    else [list(x) for x in obj.dtype.descr],
                    '__shape__': list(obj.shape),
                    '__data__': data}
        if isinstance(obj, (bool, int, float, str)) or obj is None:
            return obj
        try:
            return json.JSONEncoder.default(self, obj)
        except TypeError:
            return str(obj)


def json_object_hook(value):
    """Decoder hook inverting :class:`JSONEncoder`."""
    if '__complex__' in value:
        re, im = value['__complex__']
        return complex(re, im)
    if '__dtype__' in value:
        dtype = value['__dtype__']
        shape = tuple(value['__shape__'])
        data = value['__data__']
        if isinstance(dtype, list):  # structured
            fields = []
            for f in (tuple(x) for x in dtype):
                # reference files may carry (name, type, shape) triples
                if len(f) == 3:
                    fields.append((str(f[0]), str(f[1]), tuple(f[2])))
                else:
                    fields.append((str(f[0]), str(f[1])))
            dtype = np.dtype(fields)
            if isinstance(data, dict):
                # column-oriented layout
                arr = np.empty(shape, dtype=dtype)
                for name in dtype.names:
                    arr[name] = json_object_hook(data[name]) \
                        if isinstance(data[name], dict) else data[name]
                return arr

            # reference row-oriented layout: nested lists down to the
            # record level, each record a list of field values
            def _rows_to_tuples(d, depth):
                if depth > 0:
                    return [_rows_to_tuples(i, depth - 1) for i in d]
                return tuple(d)
            return np.array(_rows_to_tuples(data, len(shape)),
                            dtype=dtype)
        dt = np.dtype(str(dtype))
        if dt.kind == 'c':
            a = np.asarray(data, dtype='f8')
            return (a[..., 0] + 1j * a[..., 1]).astype(dt).reshape(shape)
        return np.asarray(data, dtype=dt).reshape(shape)
    return value


class JSONDecoder(json.JSONDecoder):
    def __init__(self, *args, **kwargs):
        kwargs['object_hook'] = json_object_hook
        json.JSONDecoder.__init__(self, *args, **kwargs)
