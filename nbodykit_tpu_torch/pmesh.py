"""ParticleMesh (counterpart of ``nbodykit_tpu/pmesh.py``).

- fields are tensors on the mesh's ``device``; with a ``comm`` of P
  ranks (:mod:`~nbodykit_tpu_torch.parallel.runtime`) each rank holds
  its x-slab ``(N0/P, N1, N2)`` of a real field and its ky-slab
  ``(N1/P, N0, N2//2+1)`` of a complex one, and the transforms, paint
  and readout run across the ranks (slab FFT, counted particle
  exchange, halo rows; ``parallel/``);
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
from .ops.window import window_support
from .parallel.dfft import dist_fft_plan
from .parallel.exchange import auto_capacity, exchange_by_dest
from .parallel.halo import halo_add, halo_fill
from .parallel.runtime import CurrentMesh, mesh_size, require_one_rank
from .utils import is_narrow_float, mesh_storage_dtype, stage, torch_dtype

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
    """Geometry and layout of a 3-D particle-mesh field.

    Nmesh : int or 3-vector, cells per side; BoxSize : float or
    3-vector; dtype : mesh storage dtype ('f4', 'f8' or 'bf16'); device :
    'cuda' or 'cpu' (default: the comm's device, else the ``device``
    option, else 'cuda'; raises when CUDA is absent and the CPU was not
    asked for); comm : a RankMesh of P ranks (default: the ambient
    ``CurrentMesh``; None is one rank). Nmesh[0] and Nmesh[1] must be
    divisible by P.

    ``shape_real`` / ``shape_complex`` are the global shapes;
    ``local_shape_real`` / ``local_shape_complex`` this rank's slabs.

    ``dtype`` is the numpy dtype of an f4 / f8 mesh and
    ``torch.bfloat16`` for a bf16 one (numpy has no bfloat16);
    ``compute_dtype`` is the numpy dtype the mesh computes in (f4 for
    bf16 storage), ``torch_dtype`` / ``torch_compute_dtype`` their
    torch dtypes.
    """

    logger = logging.getLogger('ParticleMesh')

    def __init__(self, Nmesh, BoxSize, dtype='f4', device=None, comm=None):
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
        self.comm = CurrentMesh.resolve(comm)
        if self.comm is not None:
            if device is not None and \
                    resolve_device(device) != self.comm.device:
                raise ValueError("device %s differs from the comm's %s"
                                 % (device, self.comm.device))
            device = self.comm.device
        self.device = resolve_device(device)
        self.nproc = mesh_size(self.comm)
        self.rank = self.comm.rank if self.comm is not None else 0
        if int(self.Nmesh[0]) % self.nproc or \
                int(self.Nmesh[1]) % self.nproc:
            raise ValueError("Nmesh[0], Nmesh[1] must be divisible by the "
                             "%d-rank mesh" % self.nproc)
        self._plan = dist_fft_plan(self.Nmesh, self.comm)

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
    def local_shape_real(self):
        """This rank's x-slab of a real field."""
        N0, N1, N2 = self.shape_real
        return (N0 // self.nproc, N1, N2)

    @property
    def local_shape_complex(self):
        """This rank's ky-slab of a complex field."""
        N1, N0, Nc = self.shape_complex
        return (N1 // self.nproc, N0, Nc)

    def _rows(self, n):
        """This rank's slice of an axis of n cells cut in nproc slabs."""
        per = n // self.nproc
        return slice(self.rank * per, (self.rank + 1) * per)

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
        """A zero (or constant) field of the requested type (this rank's
        slab)."""
        if type == 'real':
            shape, dtype = self.local_shape_real, self.torch_dtype
        elif type in ('complex', 'transposedcomplex'):
            shape, dtype = self.local_shape_complex, self.complex_dtype
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
        if self.nproc > 1:
            return self._plan.r2c(_widen(real)).mul_(scale)
        c = torch.fft.rfftn(_widen(real), dim=(0, 1, 2))
        c.mul_(scale)
        return c.permute(1, 0, 2).contiguous()

    def c2c(self, real):
        """Full complex-to-complex forward FFT of a real (or complex)
        field, forward-normalized (divides by Nmesh^3), in the
        transposed (N1, N0, N2) layout (the JAX package's
        ``dist_fftn_c2c`` times 1/Ntot)."""
        if self.nproc > 1:
            return self._plan.c2c(_widen(real).to(self.complex_dtype)).mul_(
                1.0 / self.Ntot)
        return self.forward_slabs(lambda a, b: real[a:b], full=True).permute(
            1, 0, 2).contiguous()

    def forward_slabs(self, slab, full=False):
        """The forward-normalized transform of the real field whose rows
        [a, b) along axis 0 (this rank's x-slab) are ``slab(a, b)``: the
        r2c half spectrum, or with ``full`` the c2c spectrum.

        The layout of the result depends on the rank count. On one rank
        it is the natural (N0, N1, nz) layout, and ``permute(1, 0, 2)``
        of it is the transposed layout, as a view: the field is never
        whole, since each x-slab's 2-D transform is written into the
        output, then the x-axis transform runs over y-slabs of it in
        place, so the peak is the output and a slab. With P ranks it is
        this rank's transposed ky-slab (N1/P, N0, nz) itself: the x-slab
        is built slab by slab and goes through the plan's r2c (or c2c).
        """
        N0, N1, N2 = self.shape_real
        nz = N2 if full else N2 // 2 + 1
        rows = max(1, _SLAB_ELEMENTS // (N1 * N2))
        if self.nproc > 1:
            n0 = self.local_shape_real[0]
            x = torch.empty(self.local_shape_real, dtype=self.complex_dtype
                            if full else self.torch_compute_dtype,
                            device=self.device)
            for a in range(0, n0, rows):
                x[a:a + rows] = _widen(slab(a, min(a + rows, n0)))
            out = self._plan.c2c(x) if full else self._plan.r2c(x)
            del x
            return out.mul_(1.0 / self.Ntot)
        out = torch.empty((N0, N1, nz), dtype=self.complex_dtype,
                          device=self.device)
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
        if self.nproc > 1:
            return self._plan.c2r(cplx * self.Ntot).to(self.torch_dtype)
        return self.c2r_natural(cplx.permute(1, 0, 2).contiguous())

    def c2r_natural(self, natural):
        """:meth:`c2r` of a complex field already in the natural
        (N0, N1, N2//2+1) layout, which it scales in place and consumes
        (a caller that builds the field in that layout saves the
        transposed copy). One rank only."""
        require_one_rank(self.comm, 'c2r_natural')
        natural.mul_(self.Ntot)
        return torch.fft.irfftn(natural, s=self.shape_real,
                                dim=(0, 1, 2)).to(self.torch_dtype)

    # -- coordinates ------------------------------------------------------

    def x_list(self, dtype=None):
        """Broadcastable real-space coordinates [x, y, z] of the
        (N0, N1, N2) layout (x over this rank's rows): x_i = index *
        cellsize_i, in the compute dtype unless ``dtype`` is given."""
        dtype = torch_dtype(dtype) if dtype is not None \
            else self.torch_compute_dtype
        out = []
        for ax, (n, h) in enumerate(zip(self.Nmesh, self.cellsize)):
            x = torch.arange(int(n), dtype=dtype, device=self.device) \
                * torch.tensor(h, dtype=dtype)
            if ax == 0:
                x = x[self._rows(int(n))]
            shape = [1, 1, 1]
            shape[ax] = x.shape[0]
            out.append(x.reshape(shape))
        return out

    def k_list(self, dtype=None, circular=False, full=False):
        """Broadcastable k arrays [kx, ky, kz] for the *transposed*
        complex layout (axis0=ky, axis1=kx, axis2=kz). ``circular=True``
        gives w_i = k_i * BoxSize_i / Nmesh_i; ``full=True`` the
        uncompressed kz axis. ky runs over this rank's rows."""
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
        ky = freq(N1, L[1])[self._rows(N1)].reshape(-1, 1, 1)
        nz = N2 if full else N2 // 2 + 1
        kz = freq(N2, L[2], r2c_axis=True).reshape(1, 1, nz)
        return [kx, ky, kz]

    def i_list_complex(self):
        """Broadcastable integer mode indices [ix, iy, iz] (signed,
        fftfreq convention) for the transposed complex layout."""
        N0, N1, N2 = (int(n) for n in self.Nmesh)
        ix = _fftfreq(N0, torch.int32, self.device).reshape(1, N0, 1)
        iy = _fftfreq(N1, torch.int32, self.device)[self._rows(N1)].reshape(
            -1, 1, 1)
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
        in place: the peak is the draw and two complex copies. Each rank
        draws the counters of its own slab, so the draw equals the
        single-rank one bit for bit."""
        from .rng import key, normal
        shape = self.local_shape_real
        offset = self.rank * int(np.prod(shape))
        g = normal(key(seed), shape, self.compute_dtype, self.device,
                   offset=offset)
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
        ``dtype``, as in the JAX package; with P ranks, this rank's
        rows of it, the particles of its x-slab."""
        n0, N1, N2 = self.local_shape_real
        H = self.cellsize
        axes = []
        for ax, n in enumerate((n0, N1, N2)):
            shape = [1, 1, 1]
            shape[ax] = n
            i = torch.arange(n, dtype=torch.float64, device=self.device)
            if ax == 0:
                i = i + self.rank * n0
            axes.append(((i + shift) * float(H[ax])).reshape(shape)
                        .expand(n0, N1, N2).reshape(-1))
        return torch.stack(axes, dim=-1).to(torch_dtype(dtype))

    def reshape(self, Nmesh):
        """A ParticleMesh of another resolution on the same box, dtype
        device and comm (for resampling)."""
        return ParticleMesh(Nmesh, self.BoxSize, self.dtype, self.device,
                            self.comm)

    # -- paint / readout --------------------------------------------------

    def _to_cell_units(self, pos):
        scale = torch.as_tensor(self.Nmesh / self.BoxSize, dtype=pos.dtype,
                                device=pos.device)
        return pos * scale

    def _check_halo(self, h):
        """The slab height N0/P, after checking the window's support
        ``h`` fits in it (the halo exchange reaches one neighbour)."""
        n0 = int(self.Nmesh[0]) // self.nproc
        if h > n0:
            raise ValueError(
                "resampler support %d exceeds the per-rank slab height %d "
                "(= Nmesh[0]=%d / %d ranks); use a larger Nmesh, fewer "
                "ranks, or a narrower window"
                % (h, n0, int(self.Nmesh[0]), self.nproc))
        return n0

    def _route_dest(self, cpos):
        """The rank owning each particle's slab (cpos in cell units,
        shift applied): the routing rule of paint, readout and the
        counted capacity alike."""
        N0 = int(self.Nmesh[0])
        cell = torch.remainder(torch.floor(cpos[:, 0]).to(torch.int32), N0)
        return torch.div(cell, N0 // self.nproc, rounding_mode='floor')

    def exchange_capacity(self, pos, slack=1.05, shift=0.0):
        """Pass 1 of the counted exchange: the exact per-(source,
        destination) count of these positions' routing, times ``slack``
        (``'auto'``: 1.05, the JAX package's cold tune cache), plus 8;
        the particle count on one rank. ``shift`` must match the
        paint's (interlacing routes by the half-cell-shifted grid). A
        collective: every rank calls it."""
        if self.nproc == 1:
            return int(pos.shape[0])
        if slack == 'auto':
            slack = 1.05
        dest = self._route_dest(self._to_cell_units(pos) - shift)
        return auto_capacity(dest, self.comm, slack=slack)

    def _paint_kernel(self, cpos, massa, shape, origin, resampler, cfg,
                      slack):
        """The configured paint kernel on one block: (block, the mxu
        bucket overflow count or None)."""
        method = cfg['paint_method']
        kw = dict(resampler=resampler, period=self.shape_real,
                  origin=origin)
        over = None
        if method == 'mxu':
            block, over = paint_local_mxu(
                cpos, massa, shape, slack=slack, return_overflow=True,
                order_method=cfg['paint_order'], **kw)
        elif method == 'scatter':
            block = paint_local(cpos, massa, shape,
                                chunk=cfg['paint_chunk_size'], **kw)
        elif method == 'sort':
            block = paint_local_sorted(cpos, massa, shape, **kw)
        elif method == 'segsum':
            block = paint_local_segsum(
                cpos, massa, shape, order_method=cfg['paint_order'], **kw)
        elif method == 'streams':
            block = paint_local_streams(cpos, massa, shape,
                                        streams=cfg['paint_streams'],
                                        chunk=cfg['paint_chunk_size'],
                                        storage_dtype=self.dtype, **kw)
        else:
            raise ValueError("unknown paint_method %r (choose 'auto', "
                             "'mxu', 'scatter', 'sort', 'segsum' or "
                             "'streams')" % (method,))
        # the rank passes count bad digits on the device: read them at
        # the synchronization the caller makes on the overflow counts
        if method in ('mxu', 'segsum'):
            raise_on_bad_digits(self.device)
        return block, over

    def paint(self, pos, mass=1.0, resampler=None, out=None, shift=0.0,
              capacity=None, return_dropped=False):
        """Scatter particles onto the mesh; returns a real field in the
        storage dtype (this rank's slab).

        pos : (N, 3) positions in box units on the mesh's device (this
        rank's rows); mass : scalar or (N,) weights (mass-0 slots are
        inert), taken in the compute dtype; shift : cell units, paints
        onto a half-cell-shifted grid (interlacing); capacity : the
        exchange's per-(source, destination) capacity with P ranks
        (default: the exact count); return_dropped : also return the
        number of particles dropped, which is 0.

        With ``paint_method='mxu'`` an overflowing bucket is retried with
        4x the slack until nothing drops; an explicit ``capacity`` that
        drops particles is retried doubled, up to ceil(N/P) + 8. Both
        counts are summed over the ranks, so every rank retries
        together, and the paint never drops a particle: the JAX
        package's ``return_dropped`` serves its traced paints, which
        cannot retry.
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
        slack = cfg['paint_bucket_slack']
        if self.nproc == 1:
            shape = self.shape_real
            block, over = self._paint_kernel(cpos, massa, shape, 0,
                                             resampler, cfg, slack)
            while over is not None and int(over) > 0 and slack < 1e6:
                slack *= 4
                self.logger.info("mxu paint bucket overflow (%d dropped); "
                                 "retrying with slack=%g"
                                 % (int(over), slack))
                block, over = self._paint_kernel(cpos, massa, shape, 0,
                                                 resampler, cfg, slack)
        else:
            block = self._paint_ranks(cpos, massa, resampler, cfg, slack,
                                      capacity)
        # the kernels return the compute dtype: a caller's accumulator is
        # widened before the add, and the sum narrowed once, here
        if out is not None:
            block = block + out.to(block.dtype)
        block = block.to(self.torch_dtype)
        return (block, 0) if return_dropped else block

    def _paint_ranks(self, cpos, massa, resampler, cfg, slack, capacity):
        """The paint across ranks: exchange to the slab owners, the
        kernel on the slab extended by the window's support h at
        ``origin = r*n0 - h``, then the halo rows added to their
        owners."""
        h = window_support(resampler)
        n0 = self._check_halo(h)
        N0, N1, N2 = self.shape_real
        dest = self._route_dest(cpos)
        ext_shape = (n0 + 2 * h, N1, N2)
        origin = self.rank * n0 - h
        zero = torch.zeros((), dtype=torch.int64, device=self.device)

        def attempt(cap, slack):
            with stage('dist_exchange'):
                (cpos_r, mass_r), valid, dropped = exchange_by_dest(
                    dest, [cpos, massa], self.comm, cap)
                mass_r = torch.where(valid, mass_r, 0.0)
            with stage('dist_paint_local'):
                ext, over = self._paint_kernel(cpos_r, mass_r, ext_shape,
                                               origin, resampler, cfg,
                                               slack)
            with stage('dist_halo'):
                block = halo_add(ext, h, self.comm)
            over = self.comm.all_reduce(zero if over is None
                                        else over.to(torch.int64))
            return block, dropped, over

        result = attempt(capacity, slack)
        if capacity is not None and int(result[1]) > 0:
            result, capacity = self._retry_grown(
                lambda cap: attempt(cap, slack), result, capacity,
                cpos.shape[0])
        block, _, over = result
        while int(over) > 0 and slack < 1e6:
            slack *= 4
            self.logger.info("mxu paint bucket overflow (%d dropped); "
                             "retrying with slack=%g" % (int(over), slack))
            block, _, over = attempt(capacity, slack)
        return block

    def _retry_grown(self, attempt, result, capacity, npart):
        """Eager backoff of an explicit exchange capacity: double it
        until nothing drops (the reference's paint-chunk backoff), up to
        ceil(N/P) + 8 for N particles over the ranks, which cannot
        overflow. ``result`` and ``attempt(cap)``'s value are (value,
        dropped, ...) tuples; returns the last one and its capacity."""
        ntot = int(self.comm.all_reduce(
            torch.tensor([int(npart)], device=self.device)))
        cap_max = -(-ntot // self.nproc) + 8
        while int(result[1]) > 0 and capacity < cap_max:
            capacity = min(2 * capacity, cap_max)
            self.logger.info("exchange overflow (%d dropped); retrying "
                             "with capacity=%d" % (int(result[1]), capacity))
            result = attempt(capacity)
        if int(result[1]) > 0:
            raise RuntimeError("particle exchange still overflowing at the "
                               "maximal capacity %d" % capacity)
        return result, capacity

    def readout(self, real, pos, resampler=None, grad_axis=None,
                capacity=None, return_dropped=False):
        """Interpolate a real field at particle positions (a narrow
        field re-widened to f32 first). ``grad_axis`` (0/1/2) reads
        d(readout)/d(pos[grad_axis]) instead, in cell units (times
        Nmesh/BoxSize for box units): the position cotangent of the
        paint's adjoint.

        With P ranks, ``real`` is this rank's slab and ``pos`` its rows:
        the particles travel to their slab's owner, which reads them
        out of its slab with halo rows from its neighbours, and the
        values travel back. ``capacity`` and ``return_dropped`` follow
        :meth:`paint`'s contract."""
        vals = self.readout_many([real], pos, resampler=resampler,
                                 grad_axis=grad_axis, capacity=capacity)[0]
        return (vals, 0) if return_dropped else vals

    def readout_many(self, reals, pos, resampler=None, grad_axis=None,
                     capacity=None):
        """:meth:`readout` of each real field of the list ``reals`` at
        the same positions, as a list of values. ``grad_axis`` is one
        axis (or None) for every field, or a list of one a field. With
        P ranks the particles are routed to their slabs' owners once
        for all the fields (a field listed twice takes one halo
        exchange), and each particle's values travel back together."""
        resampler = resampler or _global_options['resampler']
        axes = list(grad_axis) if isinstance(grad_axis, (list, tuple)) \
            else [grad_axis] * len(reals)
        if len(axes) != len(reals):
            raise ValueError("grad_axis lists %d axes for %d fields"
                             % (len(axes), len(reals)))
        if self.nproc == 1:
            cpos = self._to_cell_units(pos)
            return [readout_local(_widen(real), cpos, resampler=resampler,
                                  period=self.shape_real, origin=0,
                                  grad_axis=ax)
                    for real, ax in zip(reals, axes)]
        h = window_support(resampler)
        n0 = self._check_halo(h)
        cpos = self._to_cell_units(pos)
        npart = pos.shape[0]
        dest = self._route_dest(cpos)
        lidx = torch.arange(npart, dtype=torch.int64, device=self.device)
        filled = {}
        for real in reals:
            if id(real) not in filled:
                filled[id(real)] = halo_fill(_widen(real), h, self.comm)
        exts = [filled[id(real)] for real in reals]
        origin = self.rank * n0 - h

        def attempt(cap):
            (cpos_r, lidx_r), valid, dropped = exchange_by_dest(
                dest, [cpos, lidx], self.comm, cap)
            # only the particles received are read out; a pad row's
            # values stay 0 (under autograd, the pads' cotangents would
            # otherwise all be scattered into one cell)
            live = torch.nonzero(valid).squeeze(1)
            cpos_live = cpos_r[live]
            got = torch.stack([
                readout_local(ext, cpos_live, resampler=resampler,
                              period=self.shape_real, origin=origin,
                              grad_axis=ax)
                for ext, ax in zip(exts, axes)], dim=1)
            vals = torch.zeros((valid.shape[0], len(exts)), dtype=got.dtype,
                               device=self.device).index_copy(0, live, got)
            # back to the source ranks, into their rows' order; a pad
            # row goes back as -1, which its receiver sends to the spare
            # row past its own particles
            vals = self.comm.all_to_all(vals)
            lidx_r = self.comm.all_to_all(torch.where(valid, lidx_r, -1))
            lidx_r = torch.where(lidx_r < 0, npart, lidx_r)
            out = torch.zeros((npart + 1, len(exts)), dtype=vals.dtype,
                              device=self.device)
            out.index_add_(0, lidx_r, vals)
            return out[:npart], dropped

        result = attempt(capacity)
        if capacity is not None and int(result[1]) > 0:
            result, _ = self._retry_grown(attempt, result, capacity, npart)
        return list(result[0].unbind(1))


def memory_plan(Nmesh, npart, ndevices=1, dtype='f4', resampler='cic',
                paint_method='scatter', paint_chunk=None,
                paint_streams=None, hbm_bytes=None, exchange='counted',
                exchange_imbalance=1.5, workload='fftpower',
                pm_steps=None, nbins=None, bspec_method='fft',
                pairblock_tile=None):
    """Estimated peak bytes a rank of the FFTPower pipeline holds on its
    device (paint -> r2c -> |delta_k|^2 -> binning), the JAX package's
    model of its slab path: per-phase byte estimates, ``peak_bytes``,
    and ``fits`` against ``hbm_bytes`` less a 15% allocator margin.

    ``hbm_bytes`` defaults to the memory of the CUDA card the entry
    points run on (``torch.cuda.get_device_properties``); off CUDA it
    must be given. ``ndevices`` is the rank count P. ``exchange`` prices
    the routing buffers: ``'counted'`` with the two-pass counted
    capacity (~npart/P^2 * ``exchange_imbalance`` a (source,
    destination) pair), ``'ceil'`` with the always-sufficient
    ceil(npart/P). ``dtype='bf16'`` bills the real field and the streams
    paint's replica meshes at 2 bytes a cell and everything that
    computes at f32.

    ``workload='forward'`` prices the differentiable forward model
    instead: ``pm_steps`` KDK steps, the particle state (positions and
    momenta) and the three force meshes, and the reverse pass's saved
    state of every step (linear in ``pm_steps``); the report gains
    ``workload``, ``pm_steps``, ``forward_state_bytes`` and
    ``grad_residual_bytes``. ``workload='bispectrum'`` prices the
    bispectrum of ``nbins`` shells (default 4): ``bspec_method='fft'``
    as three real fields beside the complex spectrum and the transform
    workspace (``shell_fields_bytes``), ``'direct'`` as the dense phase
    blocks of edge ``pairblock_tile`` (default 1024, the tile
    ``Bispectrum`` resolves to) and the per-mode accumulators
    (``pairblock_bytes``, ``pairblock_tile``); the report gains
    ``workload``, ``nbins`` and ``bspec_method``. Both are the JAX
    package's formulas; the multi-rank FFT bispectrum's held shell
    fields (``nbins`` real slabs) are not priced.
    """
    from . import DEFAULT_PAINT_STREAMS
    from .ops.paint import ZCHUNK_BYTES
    if hbm_bytes is None:
        device = resolve_device(None)
        if device.type != 'cuda':
            raise ValueError("pass hbm_bytes: there is no CUDA card to read "
                             "it from")
        hbm_bytes = torch.cuda.get_device_properties(device).total_memory
    N = _triplet(Nmesh, 'i8')
    ndev = max(int(ndevices), 1)
    sdt = mesh_storage_dtype(dtype)
    item = sdt.itemsize          # STORAGE width: mesh buffers
    citem = max(item, 4)         # COMPUTE width: everything else
    ncells = float(np.prod(N))
    s = window_support(resampler or 'cic')

    real = item * ncells / ndev
    cplx = 2 * citem * (N[0] * N[1] * (N[2] // 2 + 1)) / ndev
    fft_ws = 2 * cplx
    pos_b = 3 * citem * npart / ndev
    chunk = _global_options['paint_chunk_size'] if paint_chunk is None \
        else paint_chunk
    live = min(npart / ndev, chunk)
    if paint_method == 'sort':
        # all s^3 deposit terms at once, (key, value) pairs, doubled by
        # the sort's out-of-place buffers
        paint_tmp = (s ** 3) * (4 + citem) * (npart / ndev) * 2
    elif paint_method == 'segsum':
        # the sort's streams plus the segment totals and their gathers
        paint_tmp = ((s ** 3) * (4 + citem) * (npart / ndev) * 2
                     + 2 * (s ** 3) * citem * (npart / ndev))
    elif paint_method == 'streams':
        # k replica meshes (storage dtype) beside the live chunk's terms
        if paint_streams is None:
            paint_streams = _global_options['paint_streams']
            if paint_streams == 'auto':
                paint_streams = DEFAULT_PAINT_STREAMS
        k = max(int(paint_streams), 1)
        paint_tmp = k * real + (s ** 3) * (4 + citem) * live
    elif paint_method == 'mxu':
        # the padded bucket payload, the ordering's keys, one stripe's
        # expansions (capped per piece) with its blocks accumulator, and
        # the halo-padded mesh rows
        slack = _global_options['paint_bucket_slack']
        nl = npart / ndev
        rb = cb = 8
        rbh, cbh = rb + s - 1, cb + s - 1
        n0l = max(int(N[0]) // ndev, 1)
        ntx = max(-(-n0l // rb), 1)
        nty = max(-(-int(N[1]) // cb), 1)
        blocks_acc = nty * rbh * cbh * int(N[2]) * citem
        stripe = min(slack * nl / ntx * (rbh * cbh + int(N[2])) * citem,
                     float(ZCHUNK_BYTES) * (1 + rbh * cbh / int(N[2]))
                     ) + blocks_acc
        paint_tmp = (slack * nl * 4 * citem
                     + nl * 8 * 2
                     + stripe
                     + (rb + s) * int(N[1]) * int(N[2]) * citem)
    else:
        paint_tmp = (s ** 3) * (4 + citem) * live
    p3 = cplx / 2               # |delta_k|^2 as real of the half-spectrum
    # send + receive buffers of (P, capacity) payload slots: positions,
    # mass, the live byte and the dest int
    if ndev > 1:
        payload = 3 * citem + citem + 1 + 4
        if exchange == 'ceil':
            cap = -(-npart // ndev)
        else:
            cap = npart / (ndev * ndev) * exchange_imbalance
        exch = 2 * ndev * cap * payload
    else:
        exch = 0.0
    phases = {
        'real_field': real,
        'complex_field': cplx,
        'fft_workspace': fft_ws,
        'positions': pos_b,
        'paint_temporaries': paint_tmp,
        'exchange_buffers': exch,
        'power3d': p3,
        'mesh_dtype': 'bfloat16' if sdt is torch.bfloat16 else sdt.name,
        'mesh_itemsize': item,
    }
    peak = max(real + pos_b + paint_tmp + exch,
               real + cplx + fft_ws + pos_b,
               cplx + p3 + pos_b)
    if workload == 'bispectrum':
        nb = max(int(nbins or 4), 1)
        if bspec_method == 'direct':
            # no mesh: the dense (tile, tile) phase blocks (4 tile^2
            # compute words) and the accumulators of the lattice modes
            from .ops.pairblock import DEFAULT_TILE
            if pairblock_tile is None:
                pairblock_tile = DEFAULT_TILE
            t = max(int(pairblock_tile), 8)
            nk = 4.0 * np.pi / 3.0 * float(nb + 1) ** 3
            pair_b = 4.0 * t * t * citem
            acc_b = 4.0 * nk * citem
            peak = pos_b + pair_b + acc_b + exch
            phases['pairblock_bytes'] = pair_b
            phases['pairblock_tile'] = t
        else:
            # a triangle's three shell-filtered real fields beside the
            # complex spectrum and the transform workspace
            shell_b = 3 * real
            peak = max(real + pos_b + paint_tmp + exch,
                       cplx + shell_b + fft_ws + pos_b)
            phases['shell_fields_bytes'] = shell_b
        phases['workload'] = 'bispectrum'
        phases['nbins'] = nb
        phases['bspec_method'] = bspec_method
    if workload == 'forward':
        steps = max(int(pm_steps or 1), 1)
        # the KDK state (positions and momenta) and three force meshes
        part_state = 6 * citem * npart / ndev
        force_fields = 3 * real
        fwd_peak = max(real + part_state + paint_tmp + exch,
                       real + cplx + fft_ws + part_state,
                       real + cplx + force_fields + part_state)
        # the reverse pass keeps each step's state, density and
        # potential, and a backward step's paint / readout pair adds a
        # real and a complex field
        residual = steps * (part_state + 2 * real)
        peak = fwd_peak + residual + real + cplx
        phases['workload'] = 'forward'
        phases['pm_steps'] = steps
        phases['forward_state_bytes'] = part_state + force_fields
        phases['grad_residual_bytes'] = residual
    phases['peak_bytes'] = peak
    phases['budget_bytes'] = 0.85 * hbm_bytes
    phases['headroom_bytes'] = 0.85 * hbm_bytes - peak
    phases['fits'] = bool(peak <= 0.85 * hbm_bytes)
    return phases
