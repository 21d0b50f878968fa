"""FFTRecon: standard BAO reconstruction of the density field
(counterpart of ``nbodykit_tpu/algorithms/fftrecon.py``).

The LGS (Lagrangian growth shift), LF2 and LRR schemes, with RSD
reversion through (bias, f, los) and Gaussian smoothing of the
displacement solve: paint the data, r2c, multiply by the smoothed
Zel'dovich kernel 1j k_d / k^2, c2r and read out at the data and the
randoms, then paint both shifted.

The mesh is f4. The kernels are formed as the JAX package forms them
under x64: the line of sight is an f8 numpy array, so mu and the kernels
are f8 (complex128) while k and the smoothing stay f4. The three
components share one forward FFT; each component's kernel is built in
turn, so one complex128 kernel is alive at a time.

With P ranks (the data's ``comm``) the paints, the r2c and the three
c2r run on the slab path, the kernels on this rank's ky rows, and the
mean density counts every rank's rows. The three displacement fields
are read out together (``ParticleMesh.readout_many``), so each
catalog's particles travel to their slabs once, not three times; on
one rank each field is read and freed in turn.
"""

import logging
import warnings

import numpy as np
import torch

from ..base.catalog import CatalogSourceBase
from ..base.mesh import Field, MeshSource
from ..parallel.runtime import same_mesh


class FFTRecon(MeshSource):
    """Reconstructed density mesh from data and randoms catalogs, on
    their device.

    data, ran : catalogs; Nmesh, BoxSize : the mesh (default: the data's
    attrs); bias, f, los : the RSD model; R : the smoothing radius;
    position : the position column; revert_rsd_random : also shift the
    randoms by the RSD factor; scheme : 'LGS', 'LF2' or 'LRR';
    resampler : the paint window.
    """

    logger = logging.getLogger('FFTRecon')

    def __init__(self, data, ran, Nmesh, bias=1.0, f=0.0, los=[0, 0, 1],
                 R=20, position='Position', revert_rsd_random=False,
                 scheme='LGS', BoxSize=None, resampler='cic'):
        if scheme not in ('LGS', 'LF2', 'LRR'):
            raise ValueError("scheme must be LGS, LF2 or LRR")
        if not isinstance(data, CatalogSourceBase) or \
                not isinstance(ran, CatalogSourceBase):
            raise TypeError("data and ran must be catalogs")
        if data.device != ran.device:
            raise ValueError("data on %s, randoms on %s"
                             % (data.device, ran.device))
        if not same_mesh(data.comm, ran.comm):
            raise ValueError("data and randoms on different meshes of "
                             "ranks: %s, %s" % (data.comm, ran.comm))

        if Nmesh is None:
            Nmesh = data.attrs['Nmesh']
        if BoxSize is None:
            BoxSize = data.attrs['BoxSize']

        los = np.array(los, dtype='f8')
        los /= (los ** 2).sum() ** 0.5

        MeshSource.__init__(self, Nmesh, BoxSize, dtype='f4',
                            device=data.device, comm=data.comm)
        if (self.pm.BoxSize / self.pm.Nmesh).max() > R:
            warnings.warn("smoothing radius is smaller than the mesh "
                          "cell; expect numerical noise")

        self.attrs.update(bias=bias, f=f, los=los, R=R, scheme=scheme,
                          revert_rsd_random=bool(revert_rsd_random))
        self.data = data
        self.ran = ran
        self.position = position
        self.resampler = resampler

    def to_real_field(self):
        return self.run()

    def run(self):
        s_d, s_r = self._compute_s()
        return self._helper_paint(s_d, s_r)

    def _paint_overdensity(self, cat, shift):
        """Paint ``cat`` at Position - shift (f4), over its mean
        density (every rank's rows)."""
        pm = self.pm
        pos = cat[self.position].to(torch.float32)
        if shift is not None:
            pos = pos - shift
        field = pm.paint(pos, 1.0, resampler=self.resampler)
        nbar = cat.csize / pm.Ntot
        return field / nbar

    def _kernel_base(self):
        """(k2, k2s, base): |k|^2 (f4), with 1 at k = 0, and the f8
        factor exp(-k^2 R^2 / 2) / (b (1 + f/b mu^2)) shared by the
        three components."""
        kx, ky, kz = self.pm.k_list()
        k2 = kx ** 2 + ky ** 2 + kz ** 2
        k2s = torch.where(k2 == 0, 1.0, k2)
        los = self.attrs['los']
        mu = (kx.double() * los[0] + ky.double() * los[1]
              + kz.double() * los[2]) / torch.sqrt(k2s).double()
        smooth = torch.exp(-0.5 * k2s * self.attrs['R'] ** 2)
        frac = self.attrs['bias'] * (
            1.0 + self.attrs['f'] / self.attrs['bias'] * mu ** 2)
        del mu
        return k2, k2s, smooth / frac

    def _displacement_kernel(self, d, k2, k2s, base):
        """The smoothed Zel'dovich kernel 1j k_d / k^2 * base of
        component ``d`` (complex128; 0 at k = 0)."""
        kd = self.pm.k_list()[d]
        im = torch.where(k2 == 0, 0.0, (kd / k2s).double() * base)
        return torch.complex(torch.zeros_like(im), im)

    def _compute_s(self):
        pm = self.pm
        delta_k = pm.r2c(self._paint_overdensity(self.data, None))
        delta_k = delta_k.to(torch.complex128)
        k2, k2s, base = self._kernel_base()
        pos_d = self.data[self.position].to(torch.float32)
        pos_r = self.ran[self.position].to(torch.float32)
        s_d, s_r, disps = [], [], []
        for d in range(3):
            kern = self._displacement_kernel(d, k2, k2s, base)
            disp = pm.c2r(delta_k * kern)
            del kern
            if pm.nproc > 1:
                disps.append(disp)
                continue
            s_d.append(pm.readout(disp, pos_d, resampler=self.resampler))
            s_r.append(pm.readout(disp, pos_r, resampler=self.resampler))
            del disp
        del delta_k, k2, k2s, base
        if disps:
            s_d = pm.readout_many(disps, pos_d, resampler=self.resampler)
            s_r = pm.readout_many(disps, pos_r, resampler=self.resampler)
        del disps, pos_d, pos_r
        s_d = torch.stack(s_d, dim=-1)
        s_r = torch.stack(s_r, dim=-1)

        # revert the RSD in the data displacement
        rsd = 1.0 + torch.as_tensor(self.attrs['los'], dtype=s_d.dtype,
                                    device=s_d.device) * self.attrs['f']
        s_d = s_d * rsd
        if self.attrs['revert_rsd_random']:
            s_r = s_r * rsd
        return s_d, s_r

    def _helper_paint(self, s_d, s_r):
        """Combine the shifted paints of the scheme."""
        delta_s_r = self._paint_overdensity(self.ran, s_r)

        def LGS():
            delta_s_d = self._paint_overdensity(self.data, s_d)
            return delta_s_d - delta_s_r

        def LRR():
            delta_s_nr = self._paint_overdensity(self.ran, -s_r)
            delta_d = self._paint_overdensity(self.data, None)
            return delta_d - 0.5 * (delta_s_nr + delta_s_r)

        if self.attrs['scheme'] == 'LGS':
            out = LGS()
        elif self.attrs['scheme'] == 'LRR':
            out = LRR()
        else:  # LF2
            out = 3.0 / 7.0 * LGS() + 4.0 / 7.0 * LRR()

        return Field(out, self.pm, 'real')
