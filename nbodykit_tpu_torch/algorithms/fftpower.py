"""FFT-based power spectrum of a periodic box (counterpart of
``nbodykit_tpu/algorithms/fftpower.py``).

P(k), P(k, mu) and multipoles P_ell(k) with the JAX package's binning
semantics: under/overflow bins, half-open mu bins with an inclusive
last bin, hermitian double-count weights with the Nyquist planes
counted once, and the dk=0 "unique edges" mode. The 3-D power and its
(k, mu, ell) reduction run as tensor ops on the field's device, chunked
over the leading axis; means and packaging happen on the host with
numpy (small arrays).

The binning follows the JAX package's f64 (x64) branch: mode
coordinates in f64, digitized against f64 squared edges. Its exact
integer branch exists for TPUs without f64 and is not ported.
"""

import json
import logging

import numpy as np
import torch

from ..base.catalog import CatalogSourceBase
from ..base.mesh import Field, FieldMesh, MeshSource
from ..binned_statistic import BinnedStatistic
from ..ops.histogram import hist2d_weighted
from ..pmesh import _fftfreq
from ..utils import JSONDecoder, JSONEncoder


def _legendre_all(ells, mu):
    """Legendre P_ell(mu) for each ell in ``ells`` by the recurrence."""
    lmax = max(ells) if ells else 0
    P_prev = torch.ones_like(mu)
    out = {0: P_prev}
    if lmax >= 1:
        P_cur = mu
        out[1] = P_cur
        for n in range(1, lmax):
            P_next = ((2 * n + 1) * mu * P_cur - n * P_prev) / (n + 1)
            P_prev, P_cur = P_cur, P_next
            out[n + 1] = P_cur
    return [out[ell] for ell in ells]


# elements per slab chunk of the binning reduction (patchable so tests
# can exercise the chunked path on small meshes)
_BIN_CHUNK_ELEMENTS = 1 << 22


def project_to_basis(y3d, edges, los=[0, 0, 1], poles=[]):
    """Bin a 3-D statistic into (x, mu) bins and optional multipoles.

    y3d : Field, a transposed hermitian-compressed complex field (binned
    in k) or a real field (binned in separation r, fftfreq order);
    edges : [xedges, muedges]; los : unit line of sight; poles : list of
    int multipoles.

    Returns (xmean_2d, mumean_2d, y2d, N_2d), (xmean_1d, poles, N_1d)
    or None. With P ranks each bins its own slab (its rows of the
    leading axis) and the f64 histograms are summed over the ranks: the
    result is the same on every rank.
    """
    pm = y3d.pm
    dev = y3d.value.device
    f8 = torch.float64
    full_complex = (y3d.kind == 'complex'
                    and y3d.shape[2] == int(pm.Nmesh[2]))
    hermitian = (y3d.kind == 'complex') and not full_complex
    xedges, muedges = edges
    Nx = len(xedges) - 1
    Nmu = len(muedges) - 1

    do_poles = len(poles) > 0
    _poles = sorted(set([0]) | set(poles))
    Nell = len(_poles)
    ell_idx = [_poles.index(ell) for ell in poles]
    if any(ell < 0 for ell in _poles):
        raise ValueError("multipole numbers must be non-negative integers")

    N0, N1, N2 = pm.shape_real
    L = pm.BoxSize
    if hermitian or full_complex:
        kx, ky, kz = pm.k_list(dtype='f8', full=full_complex)
        coords = [kx * los[0], ky * los[1], kz * los[2]]
        x2fac = [kx ** 2, ky ** 2, kz ** 2]
        if full_complex:
            w_b = torch.ones((1, 1, 1), dtype=f8, device=dev)
        else:
            w_b = pm.hermitian_weights(dtype='f8')
    else:
        rx = (_fftfreq(N0, f8, dev) * (L[0] / N0))[pm._rows(N0)].reshape(
            -1, 1, 1)
        ry = (_fftfreq(N1, f8, dev) * (L[1] / N1)).reshape(1, N1, 1)
        rz = (_fftfreq(N2, f8, dev) * (L[2] / N2)).reshape(1, 1, N2)
        coords = [rx * los[0], ry * los[1], rz * los[2]]
        x2fac = [rx ** 2, ry ** 2, rz ** 2]
        w_b = torch.ones((1, 1, 1), dtype=f8, device=dev)

    x2edges = torch.as_tensor(np.asarray(xedges, dtype='f8') ** 2,
                              device=dev)
    muedges_t = torch.as_tensor(np.asarray(muedges, dtype='f8'), device=dev)

    value = y3d.value
    is_cplx = value.is_complex()
    S0, S1, S2 = (int(s) for s in value.shape)
    rows = min(S0, max(1, _BIN_CHUNK_ELEMENTS // max(1, S1 * S2)))
    while S0 % rows:
        rows -= 1

    def slice0(a, start):
        # factors that vary along axis 0 are sliced; size-1 axes pass
        return a if a.shape[0] == 1 else a[start:start + rows]

    def chunk_hists(v_c, start):
        x2 = sum(slice0(f, start) for f in x2fac)
        xnorm = torch.sqrt(x2)
        mudot = sum(slice0(c, start) for c in coords)
        mu = torch.where(xnorm == 0, 0.0,
                         mudot / torch.where(xnorm == 0, 1.0, xnorm))
        shape = v_c.shape
        # np.digitize(x, bins) == searchsorted(bins, x, side='right')
        dig_x = torch.searchsorted(
            x2edges, x2.expand(shape).reshape(-1), right=True)
        dig_mu = torch.searchsorted(
            muedges_t, mu.expand(shape).reshape(-1).contiguous(),
            right=True)
        wf = w_b.expand(shape).reshape(-1)
        nonsing = wf == 2.0
        xw = xnorm.expand(shape).reshape(-1) * wf
        muw = mu.expand(shape).reshape(-1) * wf
        streams = [xw, muw, wf]
        legs = _legendre_all(_poles, mu)
        vre = v_c.real.to(f8).reshape(-1)
        vim = v_c.imag.to(f8).reshape(-1) if is_cplx else None
        for iell, ell in enumerate(_poles):
            leg = legs[iell].expand(shape).reshape(-1)
            yre = leg * vre
            yim = leg * vim if is_cplx else None
            if hermitian:
                if ell % 2:   # odd: real parts cancel between +k/-k
                    yre = torch.where(nonsing, 0.0, yre)
                    yim = torch.where(nonsing, 2.0 * yim, yim)
                else:         # even: imaginary parts cancel
                    yre = torch.where(nonsing, 2.0 * yre, yre)
                    if is_cplx:
                        yim = torch.where(nonsing, 0.0, yim)
            fac = (2.0 * ell + 1.0)
            streams.append(fac * yre)
            if is_cplx:
                streams.append(fac * yim)
        return hist2d_weighted(dig_x, dig_mu, streams, Nx + 2, Nmu + 2)

    hs = None
    for start in range(0, S0, rows):
        h = chunk_hists(value[start:start + rows], start)
        hs = h if hs is None else [a + b for a, b in zip(hs, h)]
    if pm.nproc > 1:
        from ..utils import stage
        with stage('dist_binning_reduce'):
            hs = pm.comm.all_reduce(torch.stack(hs)).unbind(0)
    hs = [h.cpu().numpy() for h in hs]

    xsum, musum, Nsum = hs[0], hs[1], hs[2]
    ys_re, ys_im = [], []
    k = 3
    for _ in _poles:
        ys_re.append(hs[k])
        k += 1
        if is_cplx:
            ys_im.append(hs[k])
            k += 1
        else:
            ys_im.append(np.zeros_like(hs[0]))
    ys_re = np.stack([y.reshape(-1) for y in ys_re])
    ys_im = np.stack([y.reshape(-1) for y in ys_im])

    xsum = np.array(xsum, dtype='f8').reshape(Nx + 2, Nmu + 2)
    musum = np.array(musum, dtype='f8').reshape(Nx + 2, Nmu + 2)
    Nsum = np.array(Nsum, dtype='f8').reshape(Nx + 2, Nmu + 2)
    ysum = (np.asarray(ys_re, dtype='f8')
            + 1j * np.asarray(ys_im, dtype='f8')
            ).reshape(Nell, Nx + 2, Nmu + 2)
    if not is_cplx:
        ysum = ysum.real

    # fold the internal mu == 1 bin into the last visible bin
    xsum[:, -2] += xsum[:, -1]
    musum[:, -2] += musum[:, -1]
    Nsum[:, -2] += Nsum[:, -1]
    ysum[..., -2] += ysum[..., -1]

    sl = slice(1, -1)
    with np.errstate(invalid='ignore', divide='ignore'):
        y2d = (ysum[0] / Nsum)[sl, sl]
        xmean_2d = (xsum / Nsum)[sl, sl]
        mumean_2d = (musum / Nsum)[sl, sl]
        N_2d = Nsum[sl, sl]

        pole_result = None
        if do_poles:
            N_1d = Nsum[sl, sl].sum(axis=-1)
            xmean_1d = xsum[sl, sl].sum(axis=-1) / N_1d
            pole_arr = ysum[:, sl, sl].sum(axis=-1) / N_1d
            pole_arr = pole_arr[ell_idx, ...]
            pole_result = (xmean_1d, pole_arr, N_1d)

    return (xmean_2d, mumean_2d, y2d, N_2d), pole_result


def _cast_source(source, BoxSize, Nmesh):
    """Coerce the input to a MeshSource. A catalog is painted with
    compensation onto a mesh of the ``mesh_dtype`` option, except that
    'f4' (the default) keeps the reference's 'f8' request, as the JAX
    package does with f64 enabled; 'bf16' halves the mesh storage."""
    from .. import resolve_mesh_dtype
    if isinstance(source, Field):
        source = FieldMesh(source)
    elif isinstance(source, CatalogSourceBase):
        mdt = resolve_mesh_dtype()
        source = source.to_mesh(BoxSize=BoxSize, Nmesh=Nmesh,
                                dtype='f8' if mdt == 'f4' else mdt,
                                compensated=True)
    if not isinstance(source, MeshSource):
        raise TypeError("unknown source type for FFT algorithm: %s"
                        % type(source))
    if BoxSize is not None and np.any(
            source.attrs['BoxSize'] != np.atleast_1d(BoxSize)):
        raise ValueError("mismatched BoxSize between argument and source")
    if Nmesh is not None and np.any(
            source.attrs['Nmesh'] != np.atleast_1d(Nmesh)):
        raise ValueError("mismatched Nmesh between argument and source")
    return source


def _edges_from_centers(fx, xmax, fine):
    """Midpoint edges around sorted unique centers (dedup with a fine
    quantum against round-off survivors)."""
    iy = np.round(fx / fine).astype(np.int64)
    _, ind = np.unique(iy, return_index=True)
    fx = fx[ind]
    fx = fx[fx < xmax]
    width = np.diff(fx)
    edges = fx.copy()
    edges[1:] -= width * 0.5
    edges = np.append(edges, [fx[-1] + width[-1] * 0.5])
    edges[0] = 0
    return edges, fx


def _lattice_axes(pm, kind):
    """Integer frequencies along each mesh axis and the per-axis
    physical unit: for ``'complex'`` the wave-vector lattice (the last
    axis its hermitian-compressed non-negative half), for ``'real'`` the
    minimum-image separations of a correlation field."""
    Nmesh = np.asarray(pm.Nmesh, dtype=int)
    Box = np.asarray(pm.BoxSize, dtype='f8')
    axes, units = [], []
    for ax, n in enumerate(Nmesh):
        n = int(n)
        if kind == 'complex':
            units.append(2 * np.pi / Box[ax])
            freq = (np.arange(n // 2 + 1) if ax == 2
                    else np.fft.fftfreq(n, 1.0 / n))
        elif kind == 'real':
            units.append(Box[ax] / n)
            freq = np.fft.fftfreq(n, 1.0 / n)
        else:
            raise ValueError("kind must be 'complex' or 'real'")
        axes.append(freq.astype('i8'))
    return axes, np.asarray(units)


def _find_unique_edges(pm, xmax, kind='complex'):
    """Bin edges hitting each unique coordinate modulus (the dk=0 / dr=0
    mode) of the complex layout's |k| or, with ``kind='real'``, of the
    separations |r|, enumerated on the host with numpy: on a cubic mesh
    through the exact integer lattice |i|^2, otherwise through quantized
    floats."""
    axes, units = _lattice_axes(pm, kind)
    Nmesh = np.asarray(pm.Nmesh, dtype=int)
    cubic = (Nmesh == Nmesh[0]).all() and np.allclose(units, units[0])

    if cubic:
        unit = float(units[0])
        half = int(Nmesh[0]) // 2
        present = np.zeros(3 * half * half + 1, dtype=bool)
        sq12 = (axes[1][:, None] ** 2 + axes[2][None, :] ** 2).reshape(-1)
        rows = max(1, (1 << 23) // sq12.size)
        for lo in range(0, axes[0].size, rows):
            blk = axes[0][lo:lo + rows, None] ** 2 + sq12[None, :]
            present[np.unique(blk)] = True
        fx = unit * np.sqrt(np.flatnonzero(present).astype('f8'))
        return _edges_from_centers(fx, xmax, unit * 1e-5)

    quantum = units.min() * 0.05
    c1 = (units[1] * axes[1][:, None]) ** 2 + \
        (units[2] * axes[2][None, :]) ** 2
    c1 = c1.reshape(-1)
    rows = max(1, (1 << 23) // c1.size)
    seen_q = np.empty(0, dtype='i8')
    seen_x = np.empty(0, dtype='f8')
    for lo in range(0, axes[0].size, rows):
        blk = ((units[0] * axes[0][lo:lo + rows, None]) ** 2
               + c1[None, :]).reshape(-1)
        q = (np.sqrt(blk) / quantum + 0.5).astype('i8')
        seen_q = np.concatenate([seen_q, q])
        seen_x = np.concatenate([seen_x, np.sqrt(blk)])
        _, first = np.unique(seen_q, return_index=True)
        seen_q, seen_x = seen_q[first], seen_x[first]
    fx = np.sort(seen_x)
    return _edges_from_centers(fx, xmax, units.min() * 1e-5)


class FFTBase(object):
    """Shared machinery of the periodic-box FFT algorithms: source
    casting, meta-data, 3-D power, JSON persistence."""

    def __init__(self, first, second, Nmesh, BoxSize):
        first = _cast_source(first, Nmesh=Nmesh, BoxSize=BoxSize)
        if second is not None:
            second = _cast_source(second, Nmesh=Nmesh, BoxSize=BoxSize)
        else:
            second = first
        self.first = first
        self.second = second
        self.device = first.device

        if not np.array_equal(first.attrs['BoxSize'],
                              second.attrs['BoxSize']):
            raise ValueError("BoxSize mismatch between sources")

        self.attrs = {}
        self.attrs['Nmesh'] = first.attrs['Nmesh'].copy()
        self.attrs['BoxSize'] = first.attrs['BoxSize'].copy()
        self.attrs.update(zip(['Lx', 'Ly', 'Lz'], self.attrs['BoxSize']))
        self.attrs['volume'] = self.attrs['BoxSize'].prod()

    def _compute_3d_power(self, first, second):
        """p3d = c1 * conj(c2) * V with the DC mode cleared."""
        attrs = dict(self.attrs)
        c1 = first.compute(mode='complex', Nmesh=self.attrs['Nmesh'])
        c2 = c1 if first is second else \
            second.compute(mode='complex', Nmesh=self.attrs['Nmesh'])
        p3d = c1.value * torch.conj(c2.value)
        if c1.pm.rank == 0:
            p3d[0, 0, 0] = 0.0    # the DC mode, on the first ky-slab
        # the volume is an f8 scalar: the product widens to complex128,
        # as in the JAX package
        p3d = p3d.to(torch.complex128) * float(self.attrs['BoxSize'].prod())
        attrs.update(N1=c1.attrs.get('N', 0), N2=c2.attrs.get('N', 0))
        attrs['shotnoise'] = c1.attrs.get('shotnoise', 0) \
            if self.first is self.second else 0
        return Field(p3d, c1.pm, 'complex'), attrs

    def save(self, output):
        with open(output, 'w') as ff:
            json.dump(self.__getstate__(), ff, cls=JSONEncoder)

    @classmethod
    def load(cls, output, comm=None):
        """A saved result; every rank of ``comm`` reads the same file
        (results are the same on every rank)."""
        with open(output, 'r') as ff:
            state = json.load(ff, cls=JSONDecoder)
        self = object.__new__(cls)
        self.__setstate__(state)
        self.comm = comm
        return self


class FFTPower(FFTBase):
    """P(k), P(k, mu) and multipoles P_ell(k) in a periodic box; results
    in :attr:`power` / :attr:`poles` BinnedStatistics."""

    logger = logging.getLogger('FFTPower')

    def __init__(self, first, mode, Nmesh=None, BoxSize=None, second=None,
                 los=[0, 0, 1], Nmu=5, dk=None, kmin=0., kmax=None,
                 poles=[]):
        if mode not in ['1d', '2d']:
            raise ValueError("mode must be '1d' or '2d'")
        if poles is None:
            poles = []
        if np.isscalar(los) or len(los) != 3:
            raise ValueError("line-of-sight must be a 3-vector")
        if not np.allclose(np.dot(los, los), 1.0, rtol=1e-5):
            raise ValueError("line-of-sight must be a unit vector")

        FFTBase.__init__(self, first, second, Nmesh, BoxSize)

        self.attrs['mode'] = mode
        self.attrs['los'] = los
        self.attrs['Nmu'] = Nmu
        self.attrs['poles'] = poles
        if dk is None:
            dk = 2 * np.pi / self.attrs['BoxSize'].min()
        self.attrs['dk'] = dk
        self.attrs['kmin'] = kmin
        self.attrs['kmax'] = kmax
        self.power, self.poles = self.run()
        self.attrs.update(self.power.attrs)

    def run(self):
        if self.attrs['mode'] == '1d':
            self.attrs['Nmu'] = 1

        y3d, attrs = self._compute_3d_power(self.first, self.second)

        dk = self.attrs['dk']
        kmin = self.attrs['kmin']
        kmax = self.attrs['kmax']
        if kmax is None:
            kmax = (np.pi * y3d.pm.Nmesh.min()
                    / y3d.pm.BoxSize.max() + dk / 2)

        if dk > 0:
            kedges = np.arange(kmin, kmax, dk)
            kcoords = None
        else:
            kedges, kcoords = _find_unique_edges(y3d.pm, kmax)

        muedges = np.linspace(-1, 1, self.attrs['Nmu'] + 1, endpoint=True)
        edges = [kedges, muedges]
        coords = [kcoords, None]
        result, pole_result = project_to_basis(
            y3d, edges, poles=self.attrs['poles'], los=self.attrs['los'])

        if self.attrs['mode'] == '1d':
            cols = ['k', 'power', 'modes']
            icols = [0, 2, 3]
            edges = edges[0:1]
            coords = coords[0:1]
        else:
            cols = ['k', 'mu', 'power', 'modes']
            icols = [0, 1, 2, 3]

        dtype = np.dtype([(name, result[icol].dtype.str)
                          for icol, name in zip(icols, cols)])
        power = np.squeeze(np.empty(result[0].shape, dtype=dtype))
        for icol, col in zip(icols, cols):
            power[col][:] = np.squeeze(result[icol])

        poles = None
        if pole_result is not None:
            k, pole_arr, N = pole_result
            cols = ['k'] + ['power_%d' % ell for ell in self.attrs['poles']] \
                + ['modes']
            vals = [k] + [p for p in pole_arr] + [N]
            dtype = np.dtype([(name, vals[i].dtype.str)
                              for i, name in enumerate(cols)])
            poles = np.empty(vals[0].shape, dtype=dtype)
            for i, col in enumerate(cols):
                poles[col][:] = vals[i]

        return self._make_datasets(edges, poles, power, coords, attrs)

    def _make_datasets(self, edges, poles, power, coords, attrs):
        if self.attrs['mode'] == '1d':
            power = BinnedStatistic(['k'], edges, power,
                                    fields_to_sum=['modes'],
                                    coords=coords, **attrs)
        else:
            power = BinnedStatistic(['k', 'mu'], edges, power,
                                    fields_to_sum=['modes'],
                                    coords=coords, **attrs)
        if poles is not None:
            poles = BinnedStatistic(['k'], [power.edges['k']], poles,
                                    fields_to_sum=['modes'],
                                    coords=[power.coords['k']], **attrs)
        return power, poles

    def __getstate__(self):
        return dict(power=self.power.__getstate__(),
                    poles=self.poles.__getstate__()
                    if self.poles is not None else None,
                    attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.power = BinnedStatistic.from_state(state['power'])
        self.poles = BinnedStatistic.from_state(state['poles']) \
            if state['poles'] is not None else None


class ProjectedFFTPower(FFTBase):
    """Power spectrum of the field projected onto ``axes`` (a 2-D map
    or a 1-D line): the sum over the dropped axes, the rfft of the map
    and the binning by ``bincount``, all on the field's device; only the
    (nbins,) sums reach the host. Result in :attr:`power`."""

    logger = logging.getLogger('ProjectedFFTPower')

    def __init__(self, first, Nmesh=None, BoxSize=None, second=None,
                 axes=(0, 1), dk=None, kmin=0.):
        FFTBase.__init__(self, first, second, Nmesh, BoxSize)
        if len(axes) not in (1, 2):
            raise ValueError("axes must have length 1 or 2")
        if dk is None:
            dk = 2 * np.pi / self.attrs['BoxSize'].min()
        self.attrs['dk'] = dk
        self.attrs['kmin'] = kmin
        self.attrs['axes'] = list(axes)
        self.run()

    def _map_geometry(self):
        """Host constants of the projected map's rfft spectrum: (|k|,
        half-spectrum weights, bin edges, bin ids), each of the
        spectrum's (small) shape."""
        axes = list(self.attrs['axes'])
        dims = [int(self.attrs['Nmesh'][i]) for i in axes]
        lens = [float(self.attrs['BoxSize'][i]) for i in axes]
        nd = len(dims)

        spec_shape = tuple(dims[:-1]) + (dims[-1] // 2 + 1,)
        kk = np.zeros(spec_shape, dtype='f8')
        for j in range(nd):
            kfun = 2 * np.pi / lens[j]
            if j == nd - 1:
                freq = np.arange(spec_shape[-1], dtype='f8')
            else:
                freq = np.fft.fftfreq(dims[j], d=1.0 / dims[j])
            bshape = [1] * nd
            bshape[j] = freq.size
            kk = kk + (freq * kfun).reshape(bshape) ** 2
        kmag = np.sqrt(kk)

        # the rfft keeps the non-negative half of the last axis: every
        # plane but iz = 0 (and the Nyquist plane of an even N) stands
        # for a conjugate pair and counts twice
        wgt = np.full(spec_shape, 2.0)
        wgt[..., 0] = 1.0
        if dims[-1] % 2 == 0:
            wgt[..., -1] = 1.0

        kedges = np.arange(
            self.attrs['kmin'],
            np.pi * min(dims) / max(lens) + self.attrs['dk'] / 2,
            self.attrs['dk'])
        binid = np.digitize(kmag.reshape(-1), kedges)
        return kmag, wgt, kedges, binid

    def run(self):
        axes = list(self.attrs['axes'])
        Nmesh = self.attrs['Nmesh']
        dropped = tuple(i for i in range(3) if i not in axes)
        # the sum keeps the survivors in index order; permute to the
        # requested axis order
        survivors = sorted(axes)
        perm = tuple(survivors.index(a) for a in axes)
        inv_norm = 1.0 / float(Nmesh.prod())

        kmag, wgt, kedges, binid = self._map_geometry()
        nb = len(kedges) + 1

        f1 = self.first.compute(Nmesh=Nmesh, mode='real')
        distinct = self.first is not self.second
        f2 = self.second.compute(Nmesh=Nmesh, mode='real') \
            if distinct else f1
        dev = f1.value.device

        pm = f1.pm

        def spectrum(v):
            m = v.sum(dim=dropped)
            if pm.nproc > 1:
                # every rank's part of the map, summed into the whole
                # map on every rank
                if 0 not in dropped:
                    whole = torch.zeros((int(Nmesh[0]),) + m.shape[1:],
                                        dtype=m.dtype, device=m.device)
                    whole[pm._rows(int(Nmesh[0]))] = m
                    m = whole
                m = pm.comm.all_reduce(m)
            return torch.fft.rfftn(m.permute(perm)) * inv_norm

        s1 = spectrum(f1.value)
        s2 = spectrum(f2.value) if distinct else s1
        spec = (s1 * torch.conj(s2)).reshape(-1)
        spec[0] = 0.0                                  # clear DC
        wgt_t = torch.as_tensor(wgt.reshape(-1), device=dev)
        kw_t = torch.as_tensor((wgt * kmag).reshape(-1), device=dev)
        bin_t = torch.as_tensor(binid, device=dev)
        sums = [torch.bincount(bin_t, weights=w, minlength=nb)
                for w in (kw_t, wgt_t, spec.real * wgt_t,
                          spec.imag * wgt_t)]
        ksum, nsum, psum_re, psum_im = torch.stack(sums).cpu().numpy()

        area = float(np.prod([self.attrs['BoxSize'][i] for i in axes]))
        power = np.empty(len(kedges) - 1, dtype=[
            ('k', 'f8'), ('power', 'c16'), ('modes', 'f8')])
        with np.errstate(invalid='ignore', divide='ignore'):
            inner = slice(1, -1)
            power['k'] = (ksum / nsum)[inner]
            power['power'] = ((psum_re + 1j * psum_im) / nsum)[inner] \
                * area
            power['modes'] = nsum[inner]

        self.edges = kedges
        self.power = BinnedStatistic(['k'], [kedges], power,
                                     fields_to_sum=['modes'], **self.attrs)

    def __getstate__(self):
        return dict(edges=self.edges, power=self.power.data,
                    attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.edges = state['edges']
        self.power = BinnedStatistic(['k'], [self.edges], state['power'])
