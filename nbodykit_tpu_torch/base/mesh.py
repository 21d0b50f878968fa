"""MeshSource: a recipe for a 3-D field (counterpart of
``nbodykit_tpu/base/mesh.py``), run eagerly.

A MeshSource produces a real-space or Fourier-space view of itself
(``compute``), with a queue of deferred ``apply`` actions (window
compensation, filters) run in order. Complex fields use the transposed
hermitian layout of :mod:`nbodykit_tpu_torch.pmesh`.
"""

import copy
import logging

import numpy as np
import torch

from ..parallel.runtime import require_one_rank
from ..pmesh import ParticleMesh
from ..utils import BF16_BIGFILE_DTYPE, as_numpy, bf16_bits

logger = logging.getLogger('MeshSource')


class Field(object):
    """A mesh field: a tensor on the mesh's device plus metadata."""

    def __init__(self, value, pm, kind=None, attrs=None):
        self.value = value
        self.pm = pm
        if kind is None:
            kind = 'complex' if value.is_complex() else 'real'
        self.kind = kind
        self.attrs = {} if attrs is None else attrs

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    def r2c(self):
        assert self.kind == 'real'
        return Field(self.pm.r2c(self.value), self.pm, 'complex', self.attrs)

    def c2r(self):
        assert self.kind == 'complex'
        return Field(self.pm.c2r(self.value), self.pm, 'real', self.attrs)

    def apply(self, func, kind=None):
        """Apply ``func(coords, value) -> value`` now, with the
        coordinate arrays implied by ``kind``. A :class:`MeshFilter`
        brings its own kind, and a field in the other mode than the
        filter's is transformed first (where the JAX package raises on
        the mismatched coordinates)."""
        if isinstance(func, MeshFilter):
            if func.mode == 'complex' and self.kind == 'real':
                return self.r2c().apply(func, kind)
            if func.mode == 'real' and self.kind == 'complex':
                return self.c2r().apply(func, kind)
            if kind is None:
                kind = func.kind
        if kind is None:
            kind = 'wavenumber' if self.kind == 'complex' else 'relative'
        coords = _coords_for(self.pm, self.kind, kind)
        return Field(func(coords, self.value), self.pm, self.kind,
                     self.attrs)

    def csum(self):
        """The sum over the whole field (every rank's slab)."""
        total = self.value.sum()
        if self.pm.nproc > 1:
            total = self.pm.comm.all_reduce(total)
        return total

    def cmean(self):
        """The mean over the whole field."""
        if self.pm.nproc == 1:
            return self.value.mean()
        return self.csum() / (self.value.numel() * self.pm.nproc)

    def readout(self, pos, resampler=None):
        assert self.kind == 'real'
        return self.pm.readout(self.value, pos, resampler=resampler)

    def preview(self, axes=None):
        """Project the (real) field onto ``axes`` by summing the others;
        returns host numpy (float32 for a bfloat16 field:
        :func:`~nbodykit_tpu_torch.utils.as_numpy`). With P ranks the
        projection is of the whole field and the same on every rank (a
        collective)."""
        v = self.value
        if axes is None:
            axes = (0, 1, 2)
        axes = tuple(axes) if np.iterable(axes) else (axes,)
        other = tuple(i for i in range(3) if i not in axes)
        if other:
            v = v.sum(dim=other)
        if self.pm.nproc > 1:
            comm = self.pm.comm
            if 0 in axes:
                # the x-slabs, stacked in rank order along x
                v = comm.all_gather(v)
                v = v.reshape((-1,) + tuple(v.shape[2:]))
            else:
                v = comm.all_reduce(v)
        return as_numpy(v)

    def numpy(self):
        return as_numpy(self.value)


def _coords_for(pm, field_kind, coord_kind):
    """Coordinate arrays for an apply action."""
    if field_kind == 'complex':
        if coord_kind == 'wavenumber':
            return pm.k_list()
        if coord_kind == 'circular':
            return pm.k_list(circular=True)
        if coord_kind == 'index':
            return pm.i_list_complex()
        raise ValueError("invalid coord kind %r for a complex field "
                         "(wavenumber|circular|index)" % coord_kind)
    if coord_kind in ('relative', 'untransformed'):
        return pm.x_list()
    if coord_kind == 'index':
        N0, N1, N2 = pm.shape_real
        dev = pm.device
        return [torch.arange(N0, device=dev).reshape(N0, 1, 1),
                torch.arange(N1, device=dev).reshape(1, N1, 1),
                torch.arange(N2, device=dev).reshape(1, 1, N2)]
    raise ValueError("invalid coord kind %r for a real field "
                     "(relative|index)" % coord_kind)


class MeshFilter(object):
    """Base class of named mesh filters: a subclass declares the
    coordinate ``kind`` and field ``mode`` it works in and implements
    ``filter(coords, value)``, so :meth:`MeshSource.apply` and
    :meth:`Field.apply` need not be told them."""

    kind = None
    mode = None

    def filter(self, coords, value):
        raise NotImplementedError

    def __call__(self, coords, value):
        return self.filter(coords, value)


class MeshSource(object):
    """Base class: a recipe for a 3-D field on one device. Subclasses
    implement ``to_real_field()`` or ``to_complex_field()``; users call
    :meth:`compute` with ``mode='real'|'complex'``, optionally after
    queueing transfer functions with :meth:`apply`."""

    def __init__(self, Nmesh, BoxSize, dtype='f4', device=None, comm=None):
        self.pm = ParticleMesh(Nmesh, BoxSize, dtype=dtype, device=device,
                               comm=comm)
        if not hasattr(self, 'attrs'):
            self.attrs = {}
        self.attrs['Nmesh'] = self.pm.Nmesh.copy()
        self.attrs['BoxSize'] = self.pm.BoxSize.copy()
        self._actions = []

    @property
    def device(self):
        return self.pm.device

    @property
    def comm(self):
        """The mesh's ranks (its ParticleMesh's ``comm``; None: one
        rank)."""
        return self.pm.comm

    @property
    def actions(self):
        """The queue of deferred (mode, func, kind) actions."""
        return self._actions

    def view(self):
        """A shallow copy of this mesh with its own ``attrs``; ``base``
        is this mesh."""
        view = copy.copy(self)
        view.attrs = self.attrs.copy()
        view.base = self
        return view

    def to_mesh(self):
        return self

    def __len__(self):
        return 0

    def apply(self, func, kind='wavenumber', mode='complex'):
        """A *view* of this mesh with ``func(coords, value)`` appended to
        the action queue; it runs on the ``mode``-space field with
        ``kind`` coordinates. A :class:`MeshFilter` carries its own kind
        and mode."""
        if isinstance(func, MeshFilter):
            kind = func.kind if func.kind is not None else kind
            mode = func.mode if func.mode is not None else mode
        view = copy.copy(self)
        view.attrs = self.attrs.copy()
        view._actions = self._actions + [(mode, func, kind)]
        return view

    def to_real_field(self):
        return NotImplemented

    def to_complex_field(self):
        return NotImplemented

    def to_field(self, mode='real'):
        if mode == 'real':
            real = self.to_real_field()
            if real is NotImplemented:
                real = self.to_complex_field().c2r()
            return real
        if mode == 'complex':
            cplx = self.to_complex_field()
            if cplx is NotImplemented:
                cplx = self.to_real_field().r2c()
            return cplx
        raise ValueError("mode must be 'real' or 'complex'")

    def compute(self, mode='real', Nmesh=None):
        """Produce the field: the native representation, then the action
        pipeline (alternating r2c/c2r as needed), then, when ``Nmesh``
        differs from the mesh's, a Fourier-space resample to it."""
        if mode not in ('real', 'complex'):
            raise ValueError("mode must be 'real' or 'complex'")
        native_real = (type(self).to_real_field
                       is not MeshSource.to_real_field)
        field = self.to_field('real' if native_real else 'complex')
        for amode, func, kind in self.actions:
            if amode == 'real' and field.kind != 'real':
                field = field.c2r()
            elif amode == 'complex' and field.kind != 'complex':
                field = field.r2c()
            field = field.apply(func, kind=kind)
        if Nmesh is not None and np.any(np.atleast_1d(Nmesh)
                                        != self.pm.Nmesh):
            field = self._resample(field, Nmesh)
        if mode == 'real' and field.kind != 'real':
            field = field.c2r()
        elif mode == 'complex' and field.kind != 'complex':
            field = field.r2c()
        return field

    def preview(self, axes=None, Nmesh=None, root=0):
        """Project the (optionally ``Nmesh``-resampled) real field onto
        ``axes`` and return host numpy. The projection is the same on
        every rank, so ``root`` (the reference's rank that receives it)
        changes nothing."""
        return self.compute(mode='real', Nmesh=Nmesh).preview(axes=axes)

    def save(self, output, dataset='Field', mode='real'):
        """Write the computed field and ``attrs`` as one bigfile block
        (:mod:`nbodykit_tpu_torch.io.bigfile`), flattened, with its
        shape in the ``ndarray.shape`` attr; ``mode='complex'`` writes
        the transposed (ky, kx, kz) layout that ``r2c`` gives here and
        in the JAX package. A bfloat16 field is written as the JAX
        package writes it: its raw 16-bit patterns, DTYPE '<V2'."""
        from ..io.bigfile import BigFileWriter
        require_one_rank(self.pm.comm, 'MeshSource.save')
        field = self.compute(mode=mode)
        with BigFileWriter(output, create=True) as ff:
            attrs = dict(self.attrs)
            attrs['ndarray.shape'] = np.asarray(field.shape)
            if field.value.dtype == torch.bfloat16:
                ff.write(dataset, bf16_bits(field.value).reshape(-1),
                         attrs=attrs, dtype_str=BF16_BIGFILE_DTYPE)
            else:
                ff.write(dataset, as_numpy(field.value).reshape(-1),
                         attrs=attrs)

    def _resample(self, field, Nmesh):
        """Fourier-space resample to a new mesh size: mode truncation
        (down) or zero-padding (up), as the JAX package does it.

        On each of the transposed layout's first two axes (ky, kx) the
        kept modes are two contiguous runs, the first ``ceil(n/2)``
        non-negative frequencies and the last ``n - ceil(n/2)``, with
        ``n`` the smaller of the two sizes; on kz they are a prefix of
        ``min(sN2, dN2)//2 + 1`` planes. So the copy is at most four
        block copies into the zeroed destination. Modes are copied
        unscaled, Nyquist planes included, with no hermitian repair."""
        require_one_rank(self.pm.comm, 'the Fourier resample')
        if field.kind != 'complex':
            field = field.r2c()
        src = field.value
        pm2 = self.pm.reshape(Nmesh)
        out = torch.zeros(pm2.shape_complex, dtype=src.dtype,
                          device=src.device)
        runs = [_resample_runs(s, d) for s, d in
                zip(src.shape[:2], out.shape[:2])]
        nz = min(src.shape[2], out.shape[2])
        for (s1, d1, n1) in runs[0]:
            for (s0, d0, n0) in runs[1]:
                out[d1:d1 + n1, d0:d0 + n0, :nz] = \
                    src[s1:s1 + n1, s0:s0 + n0, :nz]
        return Field(out, pm2, 'complex', field.attrs)


def _resample_runs(n_src, n_dst):
    """The (source start, destination start, length) runs of the modes a
    resample keeps on one axis of length ``n_src`` -> ``n_dst``: the
    first ``half`` frequencies and the last ``count - half``."""
    count = min(n_src, n_dst)
    half = (count + 1) // 2
    runs = [(0, 0, half)]
    if count - half:
        runs.append((n_src - (count - half), n_dst - (count - half),
                     count - half))
    return runs


class FieldMesh(MeshSource):
    """Wrap an existing :class:`Field` (or a real tensor plus BoxSize) as
    a MeshSource. A Field keeps its mesh's ranks; a tensor is one rank's
    whole field (``comm`` of more than one rank raises)."""

    def __init__(self, field, BoxSize=None, comm=None):
        if isinstance(field, Field):
            pm = field.pm
            self.attrs = dict(field.attrs)
            MeshSource.__init__(self, pm.Nmesh, pm.BoxSize,
                                dtype=pm.dtype, device=pm.device,
                                comm=pm.comm)
            self._field = field
        else:
            if BoxSize is None:
                raise ValueError("BoxSize is required when wrapping a "
                                 "plain tensor")
            if field.is_complex():
                raise ValueError("pass complex fields as Field objects "
                                 "(the layout is ambiguous)")
            dtype = {torch.float64: 'f8', torch.bfloat16: 'bf16'}.get(
                field.dtype, 'f4')
            MeshSource.__init__(self, tuple(field.shape), BoxSize,
                                dtype=dtype, device=field.device,
                                comm=comm)
            require_one_rank(self, 'FieldMesh of a tensor')
            self._field = Field(field, self.pm, 'real')

    def to_real_field(self):
        f = self._field
        return f if f.kind == 'real' else f.c2r()

    def to_complex_field(self):
        f = self._field
        return f if f.kind == 'complex' else f.r2c()
