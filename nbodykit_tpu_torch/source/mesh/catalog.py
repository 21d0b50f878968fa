"""CatalogMesh: paint a catalog onto a density mesh (counterpart of
``nbodykit_tpu/source/mesh/catalog.py``).

Window interpolation (nnb/cic/tsc/pcs), selection/weight/value columns,
interlacing (two half-cell-shifted meshes combined in k-space), window
compensation as a deferred complex-space action, and the 1+delta
normalization with N/W/W2/shotnoise attrs.
"""

import warnings

import numpy as np
import torch

from ...base.mesh import Field, MeshSource
from ...ops.window import compensation_transfer, window_support


class CatalogMesh(MeshSource):
    """A MeshSource that paints ``source``'s particles when computed, on
    the source's device."""

    def __init__(self, source, Nmesh, BoxSize, dtype='f4', resampler='cic',
                 interlaced=False, compensated=False, position='Position',
                 weight='Weight', value='Value', selection='Selection'):
        window_support(resampler)  # validate early
        self.source = source
        self.attrs = dict(source.attrs)
        MeshSource.__init__(self, Nmesh, BoxSize, dtype=dtype,
                            device=source.device, comm=source.comm)
        self.resampler = resampler
        self.interlaced = interlaced
        self.compensated = compensated
        self.position = position
        self.weight = weight
        self.value = value
        self.selection = selection
        self.attrs.update(interlaced=interlaced, compensated=compensated,
                          resampler=resampler)

    @property
    def actions(self):
        actions = self._actions
        if self.compensated:
            transfer = compensation_transfer(self.resampler,
                                             self.interlaced)
            actions = [('complex', transfer, 'circular')] + actions
        return actions

    def to_real_field(self, normalize=True):
        """Paint and normalize to 1 + delta; attrs gain N, W, W2,
        shotnoise, num_per_cell (sums over every rank's rows)."""
        pm = self.pm
        src = self.source
        pos = src[self.position]
        n = pos.shape[0]
        weight = src[self.weight] if self.weight in src else None
        value = src[self.value] if self.value in src else None
        sel = src[self.selection] if self.selection in src else None
        if weight is None:
            weight = torch.ones(n, dtype=torch.float64, device=pm.device)
        if value is None:
            value = torch.ones(n, dtype=torch.float64, device=pm.device)
        if sel is not None:
            # masked-out particles paint with zero mass
            weight = torch.where(sel, weight, 0.0)
        mass = (weight * value).to(pm.torch_dtype)

        sums = torch.stack([
            sel.sum().double() if sel is not None else
            torch.tensor(float(n), dtype=torch.float64, device=pm.device),
            weight.sum().double(), (weight ** 2).sum().double()])
        if pm.nproc > 1:
            sums = pm.comm.all_reduce(sums)
        N, W, W2 = (float(v) for v in sums)

        if not self.interlaced:
            field = pm.paint(pos, mass, resampler=self.resampler)
        else:
            # two meshes offset by half a cell, combined in k-space with
            # the phase e^{-ik.H/2} that re-centres the shifted one
            f1 = pm.paint(pos, mass, resampler=self.resampler)
            f2 = pm.paint(pos, mass, resampler=self.resampler, shift=0.5)
            c1 = pm.r2c(f1)
            c2 = pm.r2c(f2)
            kx, ky, kz = pm.k_list()
            H = pm.cellsize
            kH = (kx.double() * float(H[0]) + ky.double() * float(H[1])
                  + kz.double() * float(H[2]))
            combined = 0.5 * (c1 + c2 * torch.exp(-0.5j * kH))
            field = pm.c2r(combined)

        nbar = W / pm.Ntot
        shotnoise = float(np.prod(pm.BoxSize)) * W2 / W ** 2 if W > 0 \
            else 0.0
        attrs = dict(N=N, W=W, W2=W2, shotnoise=shotnoise,
                     num_per_cell=nbar)
        if normalize:
            if nbar > 0:
                field = field / nbar
            else:
                warnings.warn("painting an empty catalog; field set to "
                              "uniform", RuntimeWarning)
                field = torch.ones_like(field)
        return Field(field, pm, 'real', attrs)

    def to_mesh(self):
        return self


# The named compensations users pass to ``mesh.apply(func,
# kind='circular', mode='complex')``: the plain names are the pure
# sinc^p kernels (the interlaced choice of ``compensated=True``), the
# *Shotnoise names the aliasing-corrected forms (its choice without
# interlacing).

def _named_compensation(name, resampler, pure_sinc):
    func = compensation_transfer(resampler, interlaced=pure_sinc)
    func.__name__ = func.__qualname__ = name
    return func


CompensateCIC = _named_compensation('CompensateCIC', 'cic', True)
CompensateTSC = _named_compensation('CompensateTSC', 'tsc', True)
CompensatePCS = _named_compensation('CompensatePCS', 'pcs', True)
CompensateCICShotnoise = _named_compensation(
    'CompensateCICShotnoise', 'cic', False)
CompensateTSCShotnoise = _named_compensation(
    'CompensateTSCShotnoise', 'tsc', False)
CompensatePCSShotnoise = _named_compensation(
    'CompensatePCSShotnoise', 'pcs', False)
