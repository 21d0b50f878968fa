"""Distributed 3-D FFT over a slab of ranks (counterpart of the slab path
of ``nbodykit_tpu/parallel/dfft.py``).

  real field   : this rank's x-slab (N0/P, N1, N2)
  complex field: this rank's ky-slab (N1/P, N0, N2//2+1), the transposed
                 layout of the JAX package (and of pfft's
                 ``transposed=True`` plan): one all-to-all a direction.

  r2c:  (N0/P, N1, N2) --rfft ax2--> (N0/P, N1, Nc) --fft ax1-->
        --all_to_all(split ax1, concat ax0)--> (N0, N1/P, Nc)
        --fft ax0--> --transpose--> (N1/P, N0, Nc)
  c2r is the exact reverse.

The local transforms are cuFFT (``torch.fft``) on a CUDA device. The
transpose's wire format is the ``a2a_compress`` option: ``'none'`` (the
complex payload), ``'bf16'`` (real and imaginary planes in bfloat16,
re-widened on receipt) or ``'int16'`` (planes quantized against one
scale a source rank, the scale riding the same payload); the transforms
compute at full width either side.

One rank (mesh None or of size 1) transforms the whole field at once.
"""

import torch

from .runtime import mesh_size


def _a2a_mode():
    """The ``a2a_compress`` option as a wire format: ``'auto'`` is
    ``'none'``, the JAX package's value on a cold tune cache."""
    from .. import _global_options
    v = _global_options['a2a_compress']
    return 'none' if v in (None, False, 'none', 'auto') else str(v)


def _split_blocks(y, split_axis, nsplit):
    """(nsplit, ...) stack of ``y``'s nsplit equal blocks along
    ``split_axis``: block d goes to rank d."""
    return torch.stack(torch.chunk(y, nsplit, dim=split_axis)).contiguous()


def _a2a(y, mesh, split_axis, concat_axis, mode='none'):
    """One transpose collective with the JAX ``all_to_all(tiled=True)``
    semantics: ``y`` cut in P blocks along ``split_axis``, block d to
    rank d, the blocks received concatenated along ``concat_axis`` in
    source order, in wire format ``mode``. Differentiable in mode
    ``'none'`` (the backward of ``RankMesh.all_to_all`` is the inverse
    transpose); a compressed wire under autograd raises rather than
    round the gradient."""
    P = mesh.size
    if mode != 'none' and torch.is_grad_enabled() and y.requires_grad:
        raise RuntimeError(
            "a2a_compress=%r rounds the transposed field; it does not "
            "run under autograd (set a2a_compress='none' for a "
            "gradient)" % (mode,))
    if mode == 'none':
        got = mesh.all_to_all(_split_blocks(y, split_axis, P))
        return torch.cat(got.unbind(0), dim=concat_axis)
    planes = torch.stack([y.real, y.imag])
    sa, ca = split_axis + 1, concat_axis + 1
    if mode == 'bf16':
        # bfloat16 on the wire, re-widened to f32 on receipt
        narrow = planes.to(torch.bfloat16)
        got = mesh.all_to_all(_split_blocks(narrow, sa, P))
        wide = torch.cat(got.unbind(0), dim=ca).to(torch.float32)
    elif mode == 'int16':
        wdt = planes.dtype
        # one scale a source rank, computed and applied as in JAX
        scale = torch.maximum(planes.abs().max(),
                              torch.tensor(1e-30, dtype=wdt,
                                           device=planes.device))
        scale = (scale / 32767.0).to(torch.float32)
        qi = torch.round(planes / scale.to(wdt)).to(torch.int16)
        blocks = _split_blocks(qi, sa, P)
        # the scale's f32 bits as two int16 lanes after each block
        code = scale.reshape(1).view(torch.int16)
        wire = torch.cat([blocks.reshape(P, -1),
                          code.expand(P, 2)], dim=1)
        got = mesh.all_to_all(wire)
        scales = got[:, -2:].contiguous().view(torch.float32).to(wdt)
        shape = blocks.shape[1:]
        qr = got[:, :-2].reshape((P,) + tuple(shape))
        wide = torch.cat((qr.to(wdt) * scales.reshape(
            (P,) + (1,) * len(shape))).unbind(0), dim=ca)
    else:
        raise ValueError("a2a_compress must be 'none', 'bf16', 'int16' or "
                         "'auto', got %r" % (mode,))
    return torch.complex(wide[0], wide[1]).to(y.dtype)


def dist_rfftn(x, mesh=None, norm=None):
    """3-D rFFT of this rank's real x-slab (N0/P, N1, N2): returns its
    complex ky-slab (N1/P, N0, N2//2+1). ``norm`` is ``None`` or
    ``'ortho'``, as for ``torch.fft``."""
    nproc = mesh_size(mesh)
    norm = norm or 'backward'
    if nproc == 1:
        return torch.fft.rfftn(x, dim=(0, 1, 2), norm=norm).permute(
            1, 0, 2).contiguous()
    if x.shape[1] % nproc:
        raise ValueError("Nmesh[1] = %d is not divisible by the rank "
                         "count %d" % (x.shape[1], nproc))
    from ..utils import stage
    with stage('dist_r2c'):
        y = torch.fft.rfft(x, dim=2, norm=norm)
        y = torch.fft.fft(y, dim=1, norm=norm)
        y = _a2a(y, mesh, 1, 0, _a2a_mode())       # (N0, N1/P, Nc)
        y = torch.fft.fft(y, dim=0, norm=norm)
        return y.permute(1, 0, 2).contiguous()


def dist_irfftn(y, Nmesh2, mesh=None, norm=None):
    """Inverse of :func:`dist_rfftn`: this rank's ky-slab (N1/P, N0, Nc)
    to its real x-slab (N0/P, N1, Nmesh2)."""
    nproc = mesh_size(mesh)
    norm = norm or 'backward'
    if nproc == 1:
        yt = y.permute(1, 0, 2)
        return torch.fft.irfftn(yt, s=(yt.shape[0], yt.shape[1], Nmesh2),
                                dim=(0, 1, 2), norm=norm)
    from ..utils import stage
    with stage('dist_c2r'):
        z = torch.fft.ifft(y.permute(1, 0, 2), dim=0, norm=norm)
        z = _a2a(z, mesh, 0, 1, _a2a_mode())       # (N0/P, N1, Nc)
        z = torch.fft.ifft(z, dim=1, norm=norm)
        return torch.fft.irfft(z, n=Nmesh2, dim=2, norm=norm)


def dist_fftn_c2c(x, mesh=None, inverse=False, norm=None):
    """Complex-to-complex 3-D FFT. Forward: this rank's x-slab
    (N0/P, N1, N2) to its transposed ky-slab (N1/P, N0, N2); inverse:
    the reverse."""
    nproc = mesh_size(mesh)
    norm = norm or 'backward'
    fft = torch.fft.ifft if inverse else torch.fft.fft
    if nproc == 1:
        if inverse:
            return torch.fft.ifftn(x.permute(1, 0, 2), dim=(0, 1, 2),
                                   norm=norm)
        return torch.fft.fftn(x, dim=(0, 1, 2), norm=norm).permute(
            1, 0, 2).contiguous()
    mode = _a2a_mode()
    if not inverse:
        y = fft(fft(x, dim=2, norm=norm), dim=1, norm=norm)
        y = fft(_a2a(y, mesh, 1, 0, mode), dim=0, norm=norm)
        return y.permute(1, 0, 2).contiguous()
    z = fft(x.permute(1, 0, 2), dim=0, norm=norm)
    z = fft(_a2a(z, mesh, 0, 1, mode), dim=1, norm=norm)
    return fft(z, dim=2, norm=norm)


def resolve_decomp(nproc, shape=None, dtype=None, decomp=None,
                   pencil=None):
    """The decomposition of the next transform: ``('slab', None)``. The
    pencil decomposition is not ported; asking for it raises."""
    if decomp not in (None, 'slab') or pencil is not None:
        raise NotImplementedError(
            "the pencil decomposition is not ported to torch yet (ROADMAP.md, "
            "Queue A: modules to port); only 'slab' runs")
    return 'slab', None


class dist_fft_plan(object):
    """Mesh and shape bundled, so call sites read like the reference's
    ``field.r2c()`` / ``field.c2r()`` (the slab decomposition)."""

    def __init__(self, Nmesh, mesh=None, decomp=None, pencil=None):
        self.Nmesh = tuple(int(n) for n in Nmesh)
        self.mesh = mesh
        resolve_decomp(mesh_size(mesh), self.Nmesh, decomp=decomp,
                       pencil=pencil)

    def r2c(self, x, norm=None):
        return dist_rfftn(x, self.mesh, norm=norm)

    def c2r(self, y, norm=None):
        return dist_irfftn(y, self.Nmesh[2], self.mesh, norm=norm)

    def c2c(self, x, inverse=False, norm=None):
        return dist_fftn_c2c(x, self.mesh, inverse=inverse, norm=norm)

