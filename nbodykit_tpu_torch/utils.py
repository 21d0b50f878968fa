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


def torch_dtype(dt):
    """The torch dtype of a numpy dtype token ('f4', 'f8', ...)."""
    import torch
    dt = np.dtype(dt)
    key = dt.kind + str(dt.itemsize)
    try:
        return getattr(torch, TORCH_DTYPES[key])
    except KeyError:
        raise ValueError("unsupported dtype %r" % (dt,))


def as_numpy(arr):
    """Fetch a tensor (any device) or array-like to host numpy."""
    import torch
    if isinstance(arr, torch.Tensor):
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
    gives the dtype's extremes, as in the JAX package). ``comm`` is
    accepted for the JAX signature: a column lives on one device."""
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
    return as_numpy(torch.amin(lo, dim=0)), as_numpy(torch.amax(hi, dim=0))


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
