"""ConvolvedFFTPower: power-spectrum multipoles of a survey (counterpart
of ``nbodykit_tpu/algorithms/convpower/fkp.py``).

The Hand et al. 2017 estimator: by the spherical-harmonic addition
theorem a multipole ell needs 2 ell + 1 FFTs of the FKP density weighted
by a real Y_lm of the unit position vector, each transform weighted by
Y_lm of the unit wave vector. The real Y_lm are closed-form polynomials
(:func:`get_real_Ylm`) evaluated in f64 slab by slab from the axis
vectors, so no full-mesh unit-vector array is made (the six of them
take 52 GB at 1024^3 in f64).

Even multipoles take the r2c half spectrum. Any odd multipole switches
to the full c2c spectrum, since the hermitian shortcut holds only for
even ell under a varying line of sight.

With P ranks the density is this rank's x-slab and every transform its
ky-slab: the Y_lm(x) weights are formed on the rank's x rows, the
Y_lm(k) weights on its ky rows, the normalization and shot noise are
f64 sums over every rank's rows, and the binning sums the ranks'
histograms (``project_to_basis``), so the result is the same on every
rank.
"""

import json
import logging
import time
from math import factorial, pi, sqrt

import numpy as np
import torch

from ...base.mesh import Field
from ...binned_statistic import BinnedStatistic
from ...ops.window import compensation_transfer
from ...utils import JSONDecoder, JSONEncoder, stage
from ..fftpower import _find_unique_edges, project_to_basis
from .catalog import FKPCatalog
from .catalogmesh import FKPCatalogMesh

# elements of one slab of the Y_lm weights (each f64 temporary of the
# polynomial is a slab of this size)
_SLAB_ELEMENTS = 1 << 25


def get_real_Ylm(l, m):
    """The real spherical harmonic ``Ylm(x, y, z)`` of unit-vector
    tensors, in the JAX package's convention:
    P_l^m(z) = (sin theta)^m W_lm(z) with the recurrence

      W_mm = (-1)^m (2m-1)!!,  W_{m+1,m} = z (2m+1) W_mm,
      W_lm = ((2l-1) z W_{l-1,m} - (l+m-1) W_{l-2,m}) / (l - m),

    (sin theta)^m cos(m phi) and sin(|m| phi) as Re and Im of
    (x + iy)^|m|, all times sqrt((2l+1)/(4 pi) (l-|m|)!/(l+|m|)!) and
    sqrt(2) for m != 0. Polynomial in (x, y, z), so exact at the poles.
    """
    m_abs = abs(m)
    norm = sqrt((2 * l + 1) / (4 * pi)
                * factorial(l - m_abs) / factorial(l + m_abs))
    if m != 0:
        norm *= sqrt(2.0)

    def Ylm(x, y, z):
        Wmm = 1.0
        for i in range(m_abs):
            Wmm = -Wmm * (2 * i + 1)
        W = torch.full_like(z, Wmm)
        if l > m_abs:
            W_prev, W = W, z * (2 * m_abs + 1) * Wmm
            for ll in range(m_abs + 2, l + 1):
                W_prev, W = W, ((2 * ll - 1) * z * W
                                - (ll + m_abs - 1) * W_prev) / (ll - m_abs)
        if m_abs == 0:
            azim = 1.0
        else:
            re, im = x, y
            for _ in range(m_abs - 1):
                re, im = re * x - im * y, re * y + im * x
            azim = re if m >= 0 else im
        return norm * W * azim

    Ylm.l = l
    Ylm.m = m
    return Ylm


def _unit_slab(vec, start, rows, zero_norm):
    """Unit vectors of the broadcast axis vectors ``vec`` over rows
    [start, start + rows) of axis 0; a zero vector's norm is replaced
    by ``zero_norm`` (1 for positions, inf for wave vectors)."""
    v = [a[start:start + rows] if a.shape[0] > 1 else a for a in vec]
    n = torch.sqrt(sum(a * a for a in v))
    n = torch.where(n == 0, zero_norm, n)
    return [a / n for a in v]


def _slab_rows(shape):
    return max(1, _SLAB_ELEMENTS // int(np.prod(shape[1:])))


class ConvolvedFFTPower(object):
    """Power-spectrum multipoles of an FKP-weighted survey catalog.

    first : FKPCatalog or FKPCatalogMesh; poles : list of int
    multipoles; second : a cross mesh of the same FKPCatalog geometry
    (matching alpha); Nmesh : for an FKPCatalog; kmin, kmax, dk : the
    k binning (``dk=0``: one bin per unique |k|). The result is
    :attr:`poles`, with complex ``power_<ell>`` columns.
    """

    logger = logging.getLogger('ConvolvedFFTPower')

    def __init__(self, first, poles, second=None, Nmesh=None, kmin=0.,
                 kmax=None, dk=None):
        if isinstance(first, FKPCatalog):
            first = first.to_mesh(Nmesh=Nmesh)
        if not isinstance(first, FKPCatalogMesh):
            raise TypeError("first must be an FKPCatalog or "
                            "FKPCatalogMesh")
        if second is None:
            second = first
        self.first = first
        self.second = second
        self.comm = first.comm

        if np.isscalar(poles):
            poles = [poles]
        self.attrs = {
            'poles': sorted(poles),
            'dk': dk,
            'kmin': kmin,
            'kmax': kmax,
        }
        self.attrs['Nmesh'] = first.attrs['Nmesh'].copy()
        self.attrs['BoxSize'] = first.attrs['BoxSize']
        self.attrs['BoxCenter'] = first.attrs['BoxCenter']

        self.run()

    def run(self):
        pm = self.first.pm
        dk = 2 * np.pi / pm.BoxSize.min() if self.attrs['dk'] is None \
            else self.attrs['dk']
        kmin = self.attrs['kmin']
        kmax = self.attrs['kmax']
        if kmax is None:
            kmax = np.pi * pm.Nmesh.min() / pm.BoxSize.max() + dk / 2

        if dk > 0:
            kedges = np.arange(kmin, kmax, dk)
            kcoords = None
        else:
            kedges, kcoords = _find_unique_edges(pm, kmax)

        result = self._compute_multipoles(kedges)

        self.poles = BinnedStatistic(
            ['k'], [kedges], result, fields_to_sum=['modes'],
            coords=[kcoords], **self.attrs)
        self.edges = kedges

    def _compute_multipoles(self, kedges):
        pm = self.first.pm
        dev = pm.device
        volume = float(np.prod(pm.BoxSize))

        poles = sorted(self.attrs['poles'])
        if 0 not in poles:
            poles = [0] + poles
        use_c2c = any(ell % 2 for ell in poles)

        def forward(slab):
            # the scaled transform of the field whose x-slabs are
            # slab(a, b), in the transposed layout: a view of the
            # natural layout forward_slabs gives on one rank, the ky-slab
            # it gives with P ranks
            out = pm.forward_slabs(slab, full=use_c2c)
            return out.permute(1, 0, 2) if pm.nproc == 1 else out

        transfer = compensation_transfer(self.first.resampler,
                                         self.first.interlaced)
        w_circ = pm.k_list(circular=True, full=use_c2c)

        def compensated(rfield):
            A0 = forward(lambda a, b: rfield.value[a:b]).contiguous()
            transfer(w_circ, A0, inplace=True)
            return A0.mul_(volume)

        # the FKP density fields and their compensated transforms
        rfield1 = self.first.compute(Nmesh=self.attrs['Nmesh'],
                                     mode='real')
        meta1 = dict(rfield1.attrs)
        self.attrs['alpha'] = meta1['alpha']
        with stage('multipole_0'):
            A0_1 = compensated(rfield1)

        if self.first is not self.second:
            rfield2 = self.second.compute(Nmesh=self.attrs['Nmesh'],
                                          mode='real')
            if not np.allclose(meta1['alpha'], rfield2.attrs['alpha'],
                               rtol=1e-3):
                raise ValueError(
                    "cross-correlations require the same FKPCatalog "
                    "geometry (matching alpha)")
            del rfield1
            with stage('multipole_0'):
                A0_2 = compensated(rfield2)
        else:
            rfield2 = rfield1
            A0_2 = A0_1

        # normalization and shot noise from catalog sums
        for name in ['data', 'randoms']:
            self.attrs[name + '.norm'] = self.normalization(
                name, self.attrs['alpha'])
        if self.attrs['randoms.norm'] > 0:
            norm = 1.0 / self.attrs['randoms.norm']
            Adata = self.attrs['data.norm']
            Aran = self.attrs['randoms.norm']
            if not np.allclose(Adata, Aran, rtol=0.05):
                raise ValueError(
                    "normalizations from data (%.6g) and randoms (%.6g) "
                    "differ by more than 5%%; check the n(z) column "
                    "normalization and FKP weights" % (Adata, Aran))
        else:
            norm = 1.0

        # axis vectors only: the unit vectors are formed per slab; x
        # runs over this rank's rows
        N0, N1, N2 = pm.shape_real
        H = pm.cellsize
        offset = self.attrs['BoxCenter'] - pm.BoxSize / 2.0 + 0.5 * H
        f8 = torch.float64
        xvec = []
        for ax, n in enumerate((N0, N1, N2)):
            shape = [1, 1, 1]
            i = torch.arange(n, dtype=f8, device=dev)
            if ax == 0:
                i = i[pm._rows(n)]
            shape[ax] = i.shape[0]
            xvec.append((i * float(H[ax]) + float(offset[ax])).reshape(
                shape))
        kvec = pm.k_list(dtype='f8', full=use_c2c)

        dtype = [('k', 'f8')] + [('power_%d' % l, 'c16') for l in
                                 sorted(self.attrs['poles'])] + \
            [('modes', 'i8')]
        result = np.empty(len(kedges) - 1, dtype=np.dtype(dtype))
        muedges = np.linspace(-1, 1, 2)
        density2 = rfield2.value
        del rfield2

        def ell_term(ell):
            """Aell = sum_m FFT[F Ylm(x/|x|)] Ylm(k/|k|), compensated,
            times 4 pi V. The Ylm weight is cast to the density's dtype
            and the weighted density made one x-slab at a time inside
            the transform; Aell is complex128, as the f64 Ylm(k) makes
            it."""
            Aell = torch.zeros(A0_1.shape, dtype=torch.complex128,
                               device=dev)
            krows = _slab_rows(Aell.shape)
            for m in range(-ell, ell + 1):
                Ylm = get_real_Ylm(ell, m)

                def weighted(a, b):
                    wx = Ylm(*_unit_slab(xvec, a, b - a, 1.0))
                    return density2[a:b] * wx.to(density2.dtype)
                ck = forward(weighted)
                for a in range(0, Aell.shape[0], krows):
                    wk = Ylm(*_unit_slab(kvec, a, krows, float('inf')))
                    Aell[a:a + krows] += ck[a:a + krows] * wk
                    del wk
                del ck
            transfer(w_circ, Aell, inplace=True)
            return Aell.mul_(4 * np.pi * volume)

        def binned(p3d):
            with stage('binning'):
                proj, _ = project_to_basis(Field(p3d, pm, 'complex'),
                                           [kedges, muedges])
            return proj

        proj_result = None
        for ell in poles[1:]:
            t0 = time.time()
            with stage('multipole_%d' % ell):
                Aell = ell_term(ell)
            p3d = (A0_1 * norm).to(Aell.dtype)
            p3d.mul_(torch.conj(Aell))
            del Aell
            proj_result = binned(p3d)
            del p3d
            result['power_%d' % ell][:] = np.squeeze(proj_result[2])
            self.logger.info("ell = %d done (%d FFTs, %.2fs)"
                             % (ell, 2 * ell + 1, time.time() - t0))

        if 0 in self.attrs['poles']:
            p3d = A0_1 * norm
            p3d.mul_(torch.conj(A0_2))
            proj_result = binned(p3d)
            del p3d
            result['power_0'][:] = np.squeeze(proj_result[2])

        result['k'][:] = np.squeeze(proj_result[0])
        result['modes'][:] = np.squeeze(proj_result[3])

        self.attrs['shotnoise'] = self.shotnoise(self.attrs['alpha'])

        for key in ['data.W', 'randoms.W', 'data.N', 'randoms.N',
                    'data.num_per_cell', 'randoms.num_per_cell']:
            if key in meta1:
                self.attrs[key] = meta1[key]
        return result

    def _species_columns(self, name):
        """(selection, completeness weight, w_fkp of the first mesh,
        w_fkp of the second) of species ``name``."""
        mesh1, mesh2 = self.first, self.second
        cat1 = mesh1.source[name]
        w1 = cat1[mesh1.fkp_weight]
        w2 = w1 if mesh1 is mesh2 else \
            mesh2.source[name][mesh2.fkp_weight]
        return cat1[mesh1.selection], cat1[mesh1.comp_weight], w1, w2

    def _total(self, terms):
        """The sum of ``terms`` over every rank's rows, as a float."""
        s = terms.sum().reshape(1)
        if self.first.pm.nproc > 1:
            s = self.comm.all_reduce(s)
        return float(s)

    def normalization(self, name, alpha):
        """A = sum n(z) w_comp w_fkp1 w_fkp2 over the selected objects of
        ``name`` (times alpha for the randoms); Beutler et al. 2014 eqs.
        13-14. One host read."""
        sel, comp, w1, w2 = self._species_columns(name)
        nbar = self.second.source[name][self.second.nbar]
        A = self._total(torch.where(sel, nbar * comp * w1 * w2, 0.0))
        if name == 'randoms':
            A *= alpha
        return A

    def shotnoise(self, alpha):
        """S = [sum_data w_comp^2 w_fkp1 w_fkp2 + alpha^2 sum_randoms
        (...)] / randoms.norm (Beutler et al. 2014 eq. 15). One host
        read per species."""
        Pshot = 0.0
        for name in ['data', 'randoms']:
            sel, comp, w1, w2 = self._species_columns(name)
            S = self._total(torch.where(sel, comp ** 2 * w1 * w2, 0.0))
            if name == 'randoms':
                S *= alpha ** 2
            Pshot += S
        if self.attrs['randoms.norm'] > 0:
            return Pshot / self.attrs['randoms.norm']
        return 0.0

    def to_pkmu(self, mu_edges, max_ell):
        """P(k, mu) wedges from the even multipoles up to ``max_ell``:
        each wedge is sum_ell P_ell times the mean of the Legendre
        polynomial L_ell over the wedge."""
        from scipy.integrate import quad
        from scipy.special import legendre

        def coefficient(ell, mumin, mumax):
            return quad(lambda mu: legendre(ell)(mu), mumin,
                        mumax)[0] / (mumax - mumin)

        ells = list(range(0, max_ell + 1, 2))
        if any('power_%d' % ell not in self.poles for ell in ells):
            raise ValueError("need all even ells <= %d" % max_ell)

        dtype = np.dtype([('power', 'c8'), ('k', 'f8'), ('mu', 'f8')])
        data = np.zeros((self.poles.shape[0], len(mu_edges) - 1),
                        dtype=dtype)
        for imu, (lo, hi) in enumerate(zip(mu_edges[:-1], mu_edges[1:])):
            for ell in ells:
                data['power'][:, imu] += coefficient(ell, lo, hi) \
                    * self.poles['power_%d' % ell]
            data['k'][:, imu] = self.poles['k']
            data['mu'][:, imu] = 0.5 * (lo + hi)

        return BinnedStatistic(
            ['k', 'mu'], [self.poles.edges['k'], mu_edges], data,
            coords=[self.poles.coords['k'], None], **self.attrs)

    def save(self, output):
        with open(output, 'w') as ff:
            json.dump(self.__getstate__(), ff, cls=JSONEncoder)

    @classmethod
    def load(cls, output, comm=None, format='current'):
        """Load a saved result; ``format='pre000305'`` reads the layout
        of files written by nbodykit before 0.3.5 (the poles as a raw
        structured array beside flat edges). Every rank of ``comm``
        reads the same file."""
        with open(output, 'r') as ff:
            state = json.load(ff, cls=JSONDecoder)
        self = object.__new__(cls)
        if format == 'current':
            self.__setstate__(state)
        elif format == 'pre000305':
            self.__setstate_pre000305__(state)
        else:
            raise ValueError("format must be 'current' or 'pre000305'")
        self.comm = comm
        return self

    def __getstate__(self):
        return dict(edges=self.edges,
                    poles=self.poles.__getstate__(),
                    attrs=self.attrs)

    def __setstate__(self, state):
        self.attrs = state['attrs']
        self.edges = state['edges']
        self.poles = BinnedStatistic.from_state(state['poles'])

    def __setstate_pre000305__(self, state):
        self.attrs = state['attrs']
        self.edges = state['edges']
        self.poles = BinnedStatistic(['k'], [self.edges], state['poles'],
                                     fields_to_sum=['modes'])
