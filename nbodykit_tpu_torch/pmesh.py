"""ParticleMesh on one device (counterpart of ``nbodykit_tpu/pmesh.py``).

- fields are tensors on the mesh's ``device`` (single device: no comm);
- ``r2c`` / ``c2r`` follow pmesh's forward-normalized convention
  (``c2r(r2c(x)) == x``; r2c divides by Nmesh^3);
- complex fields are hermitian-compressed and *transposed*: shape
  (N1, N0, N2//2+1), leading axis = ky, as in the JAX package.
  ``torch.fft.rfftn`` returns the natural layout, so the transforms
  permute at this boundary;
- ``paint`` runs the kernel the options resolve to (``mxu`` + ``radix``
  on a CUDA device, ``scatter`` on the CPU; ``sort``, ``segsum`` and
  ``streams`` on request), with the eager mxu bucket-overflow backoff of
  the JAX package;
- a ``'bf16'`` mesh stores its real fields in bfloat16 and computes in
  f32 (``compute_dtype``): the paint's weights are f32 and the field is
  narrowed once at the exit, ``r2c`` and ``readout`` re-widen to f32
  first, ``c2r`` narrows back to the storage dtype.
"""

import logging

import numpy as np
import torch

from . import _global_options, resolve_device, resolve_paint
from .ops.paint import (paint_local, paint_local_mxu, paint_local_segsum,
                        paint_local_sorted, paint_local_streams,
                        readout_local)
from .ops.radix_cuda import raise_on_bad_digits
from .utils import is_narrow_float, mesh_storage_dtype, torch_dtype

# elements of one slab of the slab-by-slab transform
_SLAB_ELEMENTS = 1 << 25


def _triplet(x, dtype):
    a = np.empty(3, dtype=dtype)
    a[:] = x
    return a


def _widen(real):
    """A narrow (bf16) real field as f32; any other unchanged."""
    return real.to(torch.float32) if is_narrow_float(real.dtype) else real


def _fftfreq(n, dtype, device):
    """The JAX package's ``fftfreq(n, d=1/n)``: signed integer
    frequencies divided by (1/n)*n, computed in f64."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    k = torch.remainder(i + n // 2, n) - n // 2
    return (k / ((1.0 / n) * n)).to(dtype)


class ParticleMesh(object):
    """Geometry of a 3-D particle-mesh field on one device.

    Nmesh : int or 3-vector, cells per side; BoxSize : float or
    3-vector; dtype : mesh storage dtype ('f4', 'f8' or 'bf16'); device :
    'cuda' or 'cpu' (default: the ``device`` option, else 'cuda'; raises
    when CUDA is absent and the CPU was not asked for).

    ``dtype`` is the numpy dtype of an f4 / f8 mesh and
    ``torch.bfloat16`` for a bf16 one (numpy has no bfloat16);
    ``compute_dtype`` is the numpy dtype the mesh computes in (f4 for
    bf16 storage), ``torch_dtype`` / ``torch_compute_dtype`` their
    torch dtypes.
    """

    logger = logging.getLogger('ParticleMesh')

    def __init__(self, Nmesh, BoxSize, dtype='f4', device=None):
        self.Nmesh = _triplet(Nmesh, 'i8')
        self.BoxSize = _triplet(BoxSize, 'f8')
        self.dtype = mesh_storage_dtype(dtype)
        narrow = self.dtype is torch.bfloat16
        if not narrow and self.dtype not in (np.dtype('f4'),
                                             np.dtype('f8')):
            raise ValueError("mesh dtype must be 'f4', 'f8' or 'bf16', "
                             "got %r" % (dtype,))
        self.compute_dtype = np.dtype('f4') if narrow else self.dtype
        self.torch_dtype = torch_dtype(self.dtype)
        self.torch_compute_dtype = torch_dtype(self.compute_dtype)
        self.device = resolve_device(device)

    # -- shapes -----------------------------------------------------------

    @property
    def shape_real(self):
        return tuple(int(n) for n in self.Nmesh)

    @property
    def shape_complex(self):
        """Transposed, hermitian-compressed layout (ky, kx, kz)."""
        N0, N1, N2 = (int(n) for n in self.Nmesh)
        return (N1, N0, N2 // 2 + 1)

    @property
    def Ntot(self):
        return int(np.prod(self.Nmesh))

    @property
    def cellsize(self):
        return self.BoxSize / self.Nmesh

    @property
    def complex_dtype(self):
        return torch.complex64 if self.compute_dtype.itemsize <= 4 \
            else torch.complex128

    def __eq__(self, other):
        return (isinstance(other, ParticleMesh)
                and np.array_equal(self.Nmesh, other.Nmesh)
                and np.array_equal(self.BoxSize, other.BoxSize))

    def create(self, type='real', value=0.):
        """A zero (or constant) field of the requested type."""
        if type == 'real':
            shape, dtype = self.shape_real, self.torch_dtype
        elif type in ('complex', 'transposedcomplex'):
            shape, dtype = self.shape_complex, self.complex_dtype
        else:
            raise ValueError("field type must be 'real' or 'complex'")
        return torch.full(shape, value, dtype=dtype, device=self.device)

    # -- FFT --------------------------------------------------------------

    def r2c(self, real):
        """Forward real-to-complex FFT, forward-normalized (divides by
        Nmesh^3), in the transposed (N1, N0, N2//2+1) layout. The
        scaling is in place on the transform's output, so a field costs
        two complex copies at the peak, not three. A narrow (bf16) field
        is re-widened to f32 first."""
        return self._r2c_scaled(real, 1.0 / self.Ntot)

    def _r2c_scaled(self, real, scale):
        c = torch.fft.rfftn(_widen(real), dim=(0, 1, 2))
        c.mul_(scale)
        return c.permute(1, 0, 2).contiguous()

    def c2c(self, real):
        """Full complex-to-complex forward FFT of a real (or complex)
        field, forward-normalized (divides by Nmesh^3), in the
        transposed (N1, N0, N2) layout (the JAX package's
        ``dist_fftn_c2c`` times 1/Ntot)."""
        return self.forward_slabs(lambda a, b: real[a:b], full=True).permute(
            1, 0, 2).contiguous()

    def forward_slabs(self, slab, full=False):
        """The forward-normalized transform, in the natural (N0, N1, nz)
        layout, of the real field whose rows [a, b) along axis 0 are
        ``slab(a, b)``: the r2c half spectrum, or with ``full`` the c2c
        spectrum. The field is never whole: each x-slab's 2-D transform
        is written into the output, then the x-axis transform runs over
        y-slabs of it in place, so the peak is the output and a slab.
        ``permute(1, 0, 2)`` of the result is the transposed layout, as
        a view."""
        N0, N1, N2 = self.shape_real
        nz = N2 if full else N2 // 2 + 1
        out = torch.empty((N0, N1, nz), dtype=self.complex_dtype,
                          device=self.device)
        rows = max(1, _SLAB_ELEMENTS // (N1 * N2))
        for a in range(0, N0, rows):
            x = _widen(slab(a, min(a + rows, N0)))
            if full:
                torch.fft.fft2(x.to(self.complex_dtype), dim=(1, 2),
                               out=out[a:a + rows])
            else:
                torch.fft.rfft2(x, dim=(1, 2), out=out[a:a + rows])
            del x
        rows = max(1, _SLAB_ELEMENTS // (N0 * nz))
        for b in range(0, N1, rows):
            out[:, b:b + rows] = torch.fft.fft(out[:, b:b + rows], dim=0)
        return out.mul_(1.0 / self.Ntot)

    def c2r(self, cplx):
        """Inverse of :meth:`r2c` (unnormalized inverse, since the
        forward carried the 1/N^3); returns the mesh (storage) dtype."""
        return self.c2r_natural(cplx.permute(1, 0, 2).contiguous())

    def c2r_natural(self, natural):
        """:meth:`c2r` of a complex field already in the natural
        (N0, N1, N2//2+1) layout, which it scales in place and consumes
        (a caller that builds the field in that layout saves the
        transposed copy)."""
        natural.mul_(self.Ntot)
        return torch.fft.irfftn(natural, s=self.shape_real,
                                dim=(0, 1, 2)).to(self.torch_dtype)

    # -- coordinates ------------------------------------------------------

    def x_list(self, dtype=None):
        """Broadcastable real-space coordinates [x, y, z] of the
        (N0, N1, N2) layout: x_i = index * cellsize_i, in the compute
        dtype unless ``dtype`` is given."""
        dtype = torch_dtype(dtype) if dtype is not None \
            else self.torch_compute_dtype
        out = []
        for ax, (n, h) in enumerate(zip(self.Nmesh, self.cellsize)):
            shape = [1, 1, 1]
            shape[ax] = int(n)
            out.append((torch.arange(int(n), dtype=dtype, device=self.device)
                        * torch.tensor(h, dtype=dtype)).reshape(shape))
        return out

    def k_list(self, dtype=None, circular=False, full=False):
        """Broadcastable k arrays [kx, ky, kz] for the *transposed*
        complex layout (axis0=ky, axis1=kx, axis2=kz). ``circular=True``
        gives w_i = k_i * BoxSize_i / Nmesh_i; ``full=True`` the
        uncompressed kz axis."""
        dtype = torch_dtype(dtype) if dtype is not None else (
            torch.float32 if self.compute_dtype.itemsize <= 4
            else torch.float64)
        N0, N1, N2 = (int(n) for n in self.Nmesh)
        L = self.BoxSize

        def freq(n, L_i, r2c_axis=False):
            if r2c_axis and not full:
                j = torch.arange(n // 2 + 1, dtype=dtype, device=self.device)
            else:
                j = _fftfreq(n, dtype, self.device)
            if circular:
                return j * torch.tensor(2 * np.pi / n, dtype=dtype)
            return j * torch.tensor(2 * np.pi / L_i, dtype=dtype)

        kx = freq(N0, L[0]).reshape(1, N0, 1)
        ky = freq(N1, L[1]).reshape(N1, 1, 1)
        nz = N2 if full else N2 // 2 + 1
        kz = freq(N2, L[2], r2c_axis=True).reshape(1, 1, nz)
        return [kx, ky, kz]

    def i_list_complex(self):
        """Broadcastable integer mode indices [ix, iy, iz] (signed,
        fftfreq convention) for the transposed complex layout."""
        N0, N1, N2 = (int(n) for n in self.Nmesh)
        ix = _fftfreq(N0, torch.int32, self.device).reshape(1, N0, 1)
        iy = _fftfreq(N1, torch.int32, self.device).reshape(N1, 1, 1)
        iz = torch.arange(N2 // 2 + 1, dtype=torch.int32,
                          device=self.device).reshape(1, 1, -1)
        return [ix, iy, iz]

    def hermitian_weights(self, dtype='f4'):
        """Double-count weights of the compressed kz half-space: 2 for
        0 < kz < Nyquist, 1 on the kz=0 and Nyquist planes."""
        N2 = int(self.Nmesh[2])
        nz = N2 // 2 + 1
        iz = torch.arange(nz, device=self.device)
        w = torch.where((iz > 0) & ~((N2 % 2 == 0) & (iz == N2 // 2)),
                        2.0, 1.0)
        return w.to(torch_dtype(dtype)).reshape(1, 1, nz)

    # -- white noise and particle grids -------------------------------------

    def generate_whitenoise(self, seed, unitary=False, inverted_phase=False):
        """A hermitian complex field with unit variance per mode: the
        threefry normal draw of ``key(seed)`` over the real mesh (the
        JAX package's draw), through the unnormalized r2c transform,
        times 1/sqrt(Ntot), in the transposed layout. ``unitary`` sets
        every amplitude to 1; ``inverted_phase`` flips the sign. Scaled
        in place: the peak is the draw and two complex copies."""
        from .rng import key, normal
        g = normal(key(seed), self.shape_real, self.compute_dtype,
                   self.device)
        eta = self._r2c_scaled(g, 1.0 / np.sqrt(self.Ntot))
        del g
        if unitary:
            amp = eta.abs()
            amp = torch.where(amp == 0, 1.0, amp)
            eta.div_(amp)
            del amp
        if inverted_phase:
            eta.neg_()
        return eta

    def generate_uniform_particle_grid(self, shift=0.5, dtype='f4'):
        """Positions of a uniform lattice of Nmesh^3 particles, offset by
        ``shift`` cells: (Ntot, 3) in the raster order of the real mesh
        (the first axis slowest), computed in f64 and cast to
        ``dtype``, as in the JAX package."""
        N0, N1, N2 = self.shape_real
        H = self.cellsize
        axes = []
        for ax, n in enumerate((N0, N1, N2)):
            shape = [1, 1, 1]
            shape[ax] = n
            i = torch.arange(n, dtype=torch.float64, device=self.device)
            axes.append(((i + shift) * float(H[ax])).reshape(shape)
                        .expand(N0, N1, N2).reshape(-1))
        return torch.stack(axes, dim=-1).to(torch_dtype(dtype))

    def reshape(self, Nmesh):
        """A ParticleMesh of another resolution on the same box, dtype
        and device (for resampling)."""
        return ParticleMesh(Nmesh, self.BoxSize, self.dtype, self.device)

    # -- paint / readout --------------------------------------------------

    def _to_cell_units(self, pos):
        scale = torch.as_tensor(self.Nmesh / self.BoxSize, dtype=pos.dtype,
                                device=pos.device)
        return pos * scale

    def paint(self, pos, mass=1.0, resampler=None, out=None, shift=0.0):
        """Scatter particles onto the mesh; returns a real field in the
        storage dtype.

        pos : (N, 3) positions in box units on the mesh's device;
        mass : scalar or (N,) weights (mass-0 slots are inert), taken in
        the compute dtype; shift : cell units, paints onto a
        half-cell-shifted grid (interlacing). With ``paint_method='mxu'``
        an overflowing bucket is retried with 4x the slack until nothing
        drops.
        """
        resampler = resampler or _global_options['resampler']
        if pos.device != self.device:
            raise ValueError("positions on %s, mesh on %s"
                             % (pos.device, self.device))
        cpos = self._to_cell_units(pos) - shift
        npart = pos.shape[0]
        massa = torch.as_tensor(mass, dtype=self.torch_compute_dtype,
                                device=self.device).expand(npart)
        cfg = resolve_paint(self.device)
        method = cfg['paint_method']
        shape = self.shape_real
        kw = dict(resampler=resampler, period=shape, origin=0)
        if method == 'mxu':
            slack = cfg['paint_bucket_slack']
            block, over = paint_local_mxu(
                cpos, massa, shape, resampler=resampler, period=shape,
                origin=0, slack=slack, return_overflow=True,
                order_method=cfg['paint_order'])
            # the rank passes count bad digits on the device: read them
            # at the overflow count's synchronization
            raise_on_bad_digits(self.device)
            while int(over) > 0 and slack < 1e6:
                slack *= 4
                self.logger.info("mxu paint bucket overflow (%d dropped); "
                                 "retrying with slack=%g"
                                 % (int(over), slack))
                block, over = paint_local_mxu(
                    cpos, massa, shape, resampler=resampler, period=shape,
                    origin=0, slack=slack, return_overflow=True,
                    order_method=cfg['paint_order'])
        elif method == 'scatter':
            block = paint_local(cpos, massa, shape,
                                chunk=cfg['paint_chunk_size'], **kw)
        elif method == 'sort':
            block = paint_local_sorted(cpos, massa, shape, **kw)
        elif method == 'segsum':
            block = paint_local_segsum(
                cpos, massa, shape, order_method=cfg['paint_order'], **kw)
            raise_on_bad_digits(self.device)
        elif method == 'streams':
            block = paint_local_streams(cpos, massa, shape,
                                        streams=cfg['paint_streams'],
                                        chunk=cfg['paint_chunk_size'],
                                        storage_dtype=self.dtype, **kw)
        else:
            raise ValueError("unknown paint_method %r (choose 'auto', "
                             "'mxu', 'scatter', 'sort', 'segsum' or "
                             "'streams')" % (method,))
        # the kernels return the compute dtype: a caller's accumulator is
        # widened before the add, and the sum narrowed once, here
        if out is not None:
            block = block + out.to(block.dtype)
        return block.to(self.torch_dtype)

    def readout(self, real, pos, resampler=None, grad_axis=None):
        """Interpolate a real field at particle positions (a narrow
        field re-widened to f32 first). ``grad_axis`` (0/1/2) reads
        d(readout)/d(pos[grad_axis]) instead, in cell units (times
        Nmesh/BoxSize for box units): the position cotangent of the
        paint's adjoint."""
        resampler = resampler or _global_options['resampler']
        return readout_local(_widen(real), self._to_cell_units(pos),
                             resampler=resampler, period=self.shape_real,
                             origin=0, grad_axis=grad_axis)
