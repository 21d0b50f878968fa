"""Bispectrum B(k1, k2, k3) in a periodic box (counterpart of
``nbodykit_tpu/algorithms/bispectrum.py``): the FFT (Scoccimarro
triangle-count) and direct (pairblock) estimators of one statistic.

**FFT path.** With the forward-normalized transform (``pmesh.r2c``
divides by Ntot, so ``c2r(c) = sum_k c_k e^{ikx}``), the per-shell
filtered field ``delta_b(x) = c2r(delta_k * 1_{|q| in shell b})`` turns
the mesh-product sum into a sum over mode triangles closed mod Nmesh:

    sum_x delta_1 delta_2 delta_3
        = Ntot * sum_{q1+q2+q3 = 0 (mod N)} delta_q1 delta_q2 delta_q3

and the same product of unit-amplitude fields counts them, so

    B(b1, b2, b3) = V^2 * sum_x(d1 d2 d3) / sum_x(I1 I2 I3),
    Ntri          = sum_x(I1 I2 I3) / Ntot.

The three c2r's of a triangle run through one function with the
integer shell thresholds as data; three real fields and one complex
are live at a time.

**Across ranks** (a complex field on a slab mesh of P ranks: this
rank's ky-slab of the r2c output) each pass computes every shell's
filtered field once, through the slab c2r, and holds the ``nbins``
real x-slabs; each triangle's product is summed over this rank's slab,
and the partial sums of every triangle and both passes cross the ranks
in one ``all_reduce``. The count is snapped to its integer after the
reduce. That is 2 nbins transforms a run where the one-rank loop takes
6 a triangle, for nbins slabs of memory.

**Direct path.** Exact mode sums ``delta(q) = (1/W) sum_j w_j
exp(-i k_q . x_j)`` by :func:`~nbodykit_tpu_torch.ops.pairblock.pairblock_sum`
on the catalog's device, then the host's triangle combination over the
enumerated lattice shells with true (unwrapped) closure.

Shells: bin ``b`` covers ``|q| in [b+1, b+2)`` in units of the
fundamental ``kf = 2 pi / L`` (no DC), i.e. ``kedges = kf * arange(1,
nbins + 2)``, digitized on exact integer lattice norms.
"""

import logging

import numpy as np
import torch

from ..base.catalog import CatalogSourceBase
from ..base.mesh import MeshSource
from ..binned_statistic import BinnedStatistic
from ..ops.histogram import lattice_shell_edges
from ..ops.pairblock import DEFAULT_TILE
from ..utils import as_numpy, stage
from .fftpower import FFTBase
from ..parallel.runtime import mesh_size


def shell_filtered_field(pm, cplx, lo2, hi2, isq=None):
    """The per-shell filtered field ``delta_b(x) = c2r(cplx * mask)``
    with ``mask = 1_{lo2 <= |i|^2 < hi2}`` on the integer lattice: a
    full mesh-sized real field. ``isq`` is the lattice's |i|^2 on the
    transposed complex layout, when the caller has it already."""
    if isq is None:
        ix, iy, iz = pm.i_list_complex()
        isq = ix * ix + iy * iy + iz * iz
    mask = (isq >= lo2) & (isq < hi2)
    return pm.c2r(torch.where(mask, cplx, 0))


def _make_triple_sum(pm):
    """One function ``(cplx, edges2) -> sum_x d1 d2 d3`` for the run:
    ``edges2`` is a (3, 2) integer array of ``[lo2, hi2)`` shell
    thresholds. Called once per (triangle, pass); the count pass feeds
    an all-ones spectrum (``c2r(mask) = I_b``)."""
    ix, iy, iz = pm.i_list_complex()
    isq = ix * ix + iy * iy + iz * iz

    def triple(cplx, edges2):
        prod = None
        for t in range(3):
            d = shell_filtered_field(pm, cplx, int(edges2[t][0]),
                                     int(edges2[t][1]), isq=isq)
            prod = d if prod is None else prod * d
        return torch.sum(prod)

    return triple


def triangle_bins(nbins):
    """Canonical (b1 <= b2 <= b3) shell triples whose k-intervals can
    close a triangle: ``kedges[b3] < kedges[b1+1] + kedges[b2+1]``.
    Off-list cells of the (nbins,)*3 result stay NaN."""
    out = []
    for i in range(nbins):
        for j in range(i, nbins):
            for l in range(j, nbins):
                if (l + 1) < (i + 2) + (j + 2):
                    out.append((i, j, l))
    return out


def _shell_edges2(nbins, BoxSize):
    """(nbins, 2) int32 ``[lo2, hi2)`` integer squared-norm thresholds
    of the unit-width shells, and the physical edges."""
    kf = 2.0 * np.pi / float(np.min(BoxSize))
    kedges = kf * np.arange(1, nbins + 2)
    qe = lattice_shell_edges(kedges, kf)
    return np.stack([qe[:-1], qe[1:]], axis=1), kedges


def _held_triple_sums(pm, cplx, edges2, triangles):
    """This rank's partial ``sum_x d1 d2 d3`` of every triangle, (2,
    ntriangles) f8: row 0 the data pass on ``cplx``, row 1 the count
    pass (an all-ones spectrum). Each pass holds the nbins shell
    fields of this rank's slab, each one slab c2r."""
    ix, iy, iz = pm.i_list_complex()
    isq = ix * ix + iy * iy + iz * iz
    out = torch.empty((2, len(triangles)), dtype=torch.float64,
                      device=cplx.device)
    for row, spectrum in enumerate((cplx, None)):
        shells = []
        with stage('bispectrum_shells'):
            for lo2, hi2 in edges2:
                mask = (isq >= int(lo2)) & (isq < int(hi2))
                shells.append(pm.c2r(mask.to(cplx.dtype) if spectrum is None
                                     else torch.where(mask, spectrum, 0)))
        with stage('bispectrum_triples'):
            for t, (i, j, l) in enumerate(triangles):
                out[row, t] = torch.sum(shells[i] * shells[j] * shells[l])
        del shells
    return out


def fft_bispectrum(pm, cplx, nbins):
    """The Scoccimarro estimator on a complex field: ``(B, ntri)`` as
    (nbins,)*3 host arrays, NaN where no closed triangle exists.
    ``ntri`` is the ordered mod-N triangle count ``sum_x(I1 I2 I3) /
    Ntot``, snapped to an integer. With P ranks ``cplx`` is this rank's
    ky-slab and every rank returns the same arrays (module
    docstring)."""
    edges2, _ = _shell_edges2(nbins, pm.BoxSize)
    V = float(np.prod(pm.BoxSize))
    Ntot = float(pm.Ntot)
    triangles = triangle_bins(nbins)
    if pm.nproc > 1:
        partial = _held_triple_sums(pm, cplx, edges2, triangles)
        with stage('bispectrum_reduce'):
            sums = as_numpy(pm.comm.all_reduce(partial))

        def data_and_count(t, e):
            return float(sums[0, t]), float(sums[1, t])
    else:
        triple = _make_triple_sum(pm)
        ones = torch.ones(pm.shape_complex, dtype=cplx.dtype,
                          device=cplx.device)

        def data_and_count(t, e):
            return float(triple(cplx, e)), float(triple(ones, e))

    B = np.full((nbins,) * 3, np.nan, dtype='f8')
    ntri = np.full((nbins,) * 3, np.nan, dtype='f8')
    for t, (i, j, l) in enumerate(triangles):
        S, T = data_and_count(t, np.stack([edges2[i], edges2[j],
                                           edges2[l]]))
        # the count is an integer by construction (the number of closed
        # triangles): snap off the c2r rounding, as the JAX package does
        T = round(T / Ntot) * Ntot
        for perm in {(i, j, l), (i, l, j), (j, i, l), (j, l, i),
                     (l, i, j), (l, j, i)}:
            ntri[perm] = T / Ntot if T > 0 else np.nan
            B[perm] = V * V * S / T if T > 0 else np.nan
    return B, ntri


def shell_modes(nbins):
    """Host enumeration of the half-sphere integer lattice modes of the
    ``nbins`` unit-width shells: ``(qvecs, shell)``, (Nk, 3) int and
    (Nk,) in [0, nbins). Exactly one of ``q``/``-q`` is listed
    (lexicographic half); the conjugate expansion is the caller's."""
    M = nbins + 1
    r = np.arange(-M, M + 1)
    qx, qy, qz = np.meshgrid(r, r, r, indexing='ij')
    q = np.stack([qx, qy, qz], axis=-1).reshape(-1, 3)
    isq = (q.astype('i8') ** 2).sum(axis=1)
    shell = np.floor(np.sqrt(isq.astype('f8'))).astype('i8') - 1
    keep = (isq >= 1) & (shell < nbins)
    half = (q[:, 2] > 0) \
        | ((q[:, 2] == 0) & (q[:, 1] > 0)) \
        | ((q[:, 2] == 0) & (q[:, 1] == 0) & (q[:, 0] > 0))
    sel = keep & half
    return q[sel], shell[sel].astype('i8')


def _combine_triangles(q, shell, delta, nbins, chunk=512):
    """Host triangle combination of full-sphere direct modes with true
    (unwrapped) closure ``q3 = -(q1 + q2)``: ``(S, cnt)`` with
    ``S[b1, b2, b3]`` the sum of ``delta_q1 delta_q2 delta_q3`` over
    ordered closed triples and ``cnt`` their count. A dense integer
    lookup table (q -> mode index, -1 outside), chunked over q1 rows;
    the JAX package's numpy, unchanged."""
    M = int(np.abs(q).max())
    side = 2 * M + 1
    lut = np.full(side ** 3, -1, dtype='i8')
    flat = ((q[:, 0] + M) * side + (q[:, 1] + M)) * side + (q[:, 2] + M)
    lut[flat] = np.arange(q.shape[0])

    S = np.zeros((nbins,) * 3, dtype='c16')
    cnt = np.zeros((nbins,) * 3, dtype='f8')
    for b1 in range(nbins):
        i1 = np.flatnonzero(shell == b1)
        for b2 in range(nbins):
            i2 = np.flatnonzero(shell == b2)
            q2 = q[i2]
            d2 = delta[i2]
            for lo in range(0, i1.size, chunk):
                i1c = i1[lo:lo + chunk]
                q3 = -(q[i1c][:, None, :] + q2[None, :, :])
                inside = np.abs(q3).max(axis=-1) <= M
                f3 = ((q3[..., 0] + M) * side
                      + (q3[..., 1] + M)) * side + (q3[..., 2] + M)
                t = np.where(inside, lut[np.where(inside, f3, 0)], -1)
                valid = t >= 0
                s3 = np.where(valid, shell[np.where(valid, t, 0)], -1)
                prod = delta[i1c][:, None] * d2[None, :] \
                    * delta[np.where(valid, t, 0)]
                for b3 in range(nbins):
                    m = (s3 == b3)
                    S[b1, b2, b3] += prod[m].sum()
                    cnt[b1, b2, b3] += float(m.sum())
    return S, cnt


def direct_bispectrum(pos, w, BoxSize, nbins, tile=None, comm=None):
    """The blocked direct-summation estimator: exact mode sums by
    :func:`~nbodykit_tpu_torch.ops.pairblock.pairblock_sum` on the
    device of ``pos``, host triangle combination. ``(B, ntri)`` as
    (nbins,)*3 host arrays, NaN where no closed (unwrapped) triangle
    exists. ``comm`` is :func:`pairblock_sum`'s: across ranks ``pos``
    and ``w`` are this rank's rows, the modes and the weight total are
    sums over the ranks, and every rank combines the triangles."""
    from ..ops.pairblock import lattice_kvecs, pairblock_sum

    BoxSize = np.ones(3) * np.asarray(BoxSize, dtype='f8')
    V = float(np.prod(BoxSize))
    q_half, shell_half = shell_modes(nbins)
    kv = lattice_kvecs(q_half, BoxSize)
    pos = torch.as_tensor(pos)
    w = torch.as_tensor(w, device=pos.device)
    modes = pairblock_sum(pos, w, kv, tile=tile, comm=comm)
    W = torch.sum(w)
    if mesh_size(comm) > 1:
        W = comm.all_reduce(W.to(torch.float64))
    W = float(W)
    d_half = as_numpy(modes) / W

    # conjugate expansion to the full sphere
    q = np.concatenate([q_half, -q_half])
    shell = np.concatenate([shell_half, shell_half])
    delta = np.concatenate([d_half, np.conj(d_half)])

    S, cnt = _combine_triangles(q, shell, delta, nbins)
    with np.errstate(invalid='ignore', divide='ignore'):
        B = np.where(cnt > 0, V * V * S.real / np.where(cnt > 0, cnt, 1),
                     np.nan)
    ntri = np.where(cnt > 0, cnt, np.nan)
    return B, ntri


class Bispectrum(FFTBase):
    """B(k1, k2, k3) on unit-width k shells in a periodic box.

    ``method`` is ``'fft'``, ``'direct'`` or ``'auto'``; ``'auto'``
    and ``tile=None`` resolve as the JAX package's tuner does on a cold
    cache, to ``'fft'`` and tile 1024 (the port has no tuner). The
    direct path sums over particles and needs a catalog source. The FFT
    path runs across the ranks of the source's ``comm``, and so does
    the direct path (each rank's particles summed, one reduce).

    Results land in :attr:`B`, a ``BinnedStatistic`` over ``(k1, k2,
    k3)`` with fields ``B`` and ``ntri`` (NaN outside the
    closed-triangle region).
    """

    logger = logging.getLogger('Bispectrum')

    def __init__(self, source, nbins=4, Nmesh=None, BoxSize=None,
                 method='auto', tile=None):
        if method not in ('auto', 'fft', 'direct'):
            raise ValueError("method must be 'auto', 'fft' or "
                             "'direct'")
        nbins = int(nbins)
        if nbins < 1:
            raise ValueError("nbins must be >= 1")

        is_catalog = isinstance(source, CatalogSourceBase) and \
            not isinstance(source, MeshSource)
        if method == 'direct' and not is_catalog:
            raise ValueError("the direct bispectrum path sums over "
                             "particles; pass a catalog source")
        if method == 'auto':
            method = 'fft'
        if tile is None:
            tile = DEFAULT_TILE

        if method == 'direct':
            box = BoxSize if BoxSize is not None \
                else source.attrs['BoxSize']
            box = np.ones(3) * np.asarray(box, dtype='f8')
            self.first = self.second = source
            self.comm = source.comm
            self.device = source.device
            self.attrs = {'Nmesh': np.atleast_1d(
                Nmesh if Nmesh is not None else 0),
                'BoxSize': box, 'volume': float(box.prod())}
            pos = source['Position']
            w = source['Weight'] if 'Weight' in source \
                else torch.ones(pos.shape[0], dtype=pos.dtype,
                                device=pos.device)
            B, ntri = direct_bispectrum(pos, w, box, nbins, tile=tile,
                                        comm=self.comm)
        else:
            FFTBase.__init__(self, source, None, Nmesh, BoxSize)
            c1 = self.first.compute(mode='complex',
                                    Nmesh=self.attrs['Nmesh'])
            B, ntri = fft_bispectrum(c1.pm, c1.value, nbins)
            box = np.asarray(self.attrs['BoxSize'], dtype='f8')

        _, kedges = _shell_edges2(nbins, box)
        self.attrs.update(nbins=nbins, method=method,
                          kf=float(2 * np.pi / box.min()))
        centers = 0.5 * (kedges[1:] + kedges[:-1])
        sh = (nbins,) * 3
        data = {
            'k1': np.broadcast_to(centers[:, None, None], sh).copy(),
            'k2': np.broadcast_to(centers[None, :, None], sh).copy(),
            'k3': np.broadcast_to(centers[None, None, :], sh).copy(),
            'B': B, 'ntri': ntri,
        }
        self.B = BinnedStatistic(['k1', 'k2', 'k3'], [kedges] * 3,
                                 data, fields_to_sum=['ntri'],
                                 **self.attrs)

    def __getstate__(self):
        return dict(B=self.B.__getstate__(), attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.B = BinnedStatistic.from_state(state['B'])
