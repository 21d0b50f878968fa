"""Small shared utilities (counterpart of ``nbodykit_tpu/utils.py``).

``working_dtype`` is the identity on dtypes here: PyTorch has the
64-bit float, complex and integer types on the CPU and on the H100,
so no request is demoted. JSON encoding of numpy-laden attrs dicts
keeps the JAX package's format, so a result saved by either package
loads in the other.
"""

import json

import numpy as np


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
