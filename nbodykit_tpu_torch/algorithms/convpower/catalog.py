"""FKPCatalog: data and randoms under one namespace, with FKP weights
and a shared bounding box (counterpart of
``nbodykit_tpu/algorithms/convpower/catalog.py``).

With P ranks each rank holds its rows of both catalogs; the bounding
box and every choice that precedes a collective come from totals over
the ranks, so every rank takes the same branch."""

import numpy as np
import torch

from ...source.catalog.species import MultipleSpeciesCatalog
from ...parallel.runtime import mesh_size


def FKPWeightFromNbar(P0, nbar):
    """w_FKP = 1 / (1 + P0 n(z)) (Feldman, Kaiser & Peacock 1994);
    1 when ``P0`` is 0."""
    if P0 != 0:
        return 1.0 / (1.0 + P0 * nbar)
    return 1.0


class FKPCatalog(MultipleSpeciesCatalog):
    """'data' and 'randoms' catalogs with FKP weighting.

    BoxSize : the mesh box (default: the padded extent of the randoms,
    or of the data without randoms); BoxPad : fractional padding of
    that extent; P0 : builds ``FKPWeight`` from the ``nbar`` column
    (default: an existing ``FKPWeight`` column, else 1); nbar : the
    n(z) column's name. ``randoms=None`` uses an empty slice of the
    data.
    """

    def __init__(self, data, randoms, BoxSize=None, BoxPad=0.02,
                 P0=None, nbar='NZ'):
        if randoms is None:
            randoms = data[:0]
        MultipleSpeciesCatalog.__init__(self, ['data', 'randoms'],
                                        data, randoms)
        for name in self.species:
            if nbar not in self[name]:
                raise ValueError("column %r is not defined in %r"
                                 % (nbar, name))
        self.nbar = nbar

        for name in self.species:
            if P0 is not None:
                self[name]['FKPWeight'] = FKPWeightFromNbar(
                    P0, self[name][self.nbar])
            elif 'FKPWeight' not in self[name]:
                self[name]['FKPWeight'] = torch.ones(
                    len(self[name]), dtype=torch.float64,
                    device=self.device)

        if BoxSize is not None and np.isscalar(BoxSize):
            BoxSize = np.ones(3) * BoxSize
        self.attrs['BoxSize'] = BoxSize
        if np.isscalar(BoxPad):
            BoxPad = np.ones(3) * BoxPad
        self.attrs['BoxPad'] = BoxPad

    def _define_bbox(self, position, selection, species):
        """(BoxSize, BoxCenter) from the extent of the selected
        positions of ``species`` on every rank: the extent times 1 +
        BoxPad, rounded up to whole units, unless BoxSize was given. The
        extent is reduced on the device (a rank with no selected rows
        gives the reduction's identities, +inf and -inf); six numbers
        reach the host."""
        cat = self[species]
        pos = cat[position]
        sel = cat[selection].to(torch.bool)
        nsel = int(sel.sum())
        ranks = mesh_size(self.comm) > 1
        total = int(self.comm.all_reduce(torch.tensor(
            [nsel], device=self.device))) if ranks else nsel
        if total == 0:
            raise ValueError("no selected objects in %r to define the "
                             "bounding box" % species)
        if nsel < len(sel):
            pos = pos[sel]
        if nsel > 0:
            lo, hi = torch.aminmax(pos, dim=0)
        else:
            lo = torch.full(pos.shape[1:], float('inf'), dtype=pos.dtype,
                            device=pos.device)
            hi = -lo
        if ranks:
            lo, neg_hi = self.comm.all_reduce(torch.stack([lo, -hi]),
                                              op='min')
            hi = -neg_hi
        pos_min, pos_max = torch.stack([lo, hi]).cpu().numpy()
        if np.isinf(pos_min).any() or np.isinf(pos_max).any():
            raise ValueError("infinite position range in %r" % species)

        delta = np.abs(pos_max - pos_min)
        BoxCenter = 0.5 * (pos_min + pos_max)
        if self.attrs['BoxSize'] is None:
            delta = delta * (1.0 + self.attrs['BoxPad'])
            BoxSize = np.ceil(delta)
        else:
            BoxSize = self.attrs['BoxSize']
        return BoxSize, BoxCenter

    def to_mesh(self, Nmesh=None, BoxSize=None, BoxCenter=None,
                dtype='f8', interlaced=False, compensated=False,
                resampler='cic', fkp_weight='FKPWeight',
                comp_weight='Weight', selection='Selection',
                position='Position', bbox_from_species=None, nbar=None):
        """An FKPCatalogMesh painting data - alpha randoms. The mesh is
        real; ConvolvedFFTPower takes the full complex transform when
        odd multipoles are asked for, so 'c16' / 'c8' mean 'f8' / 'f4'.
        """
        from .catalogmesh import FKPCatalogMesh
        if nbar is None:
            nbar = self.nbar
        if Nmesh is None:
            Nmesh = self.attrs.get('Nmesh', None)
            if Nmesh is None:
                raise ValueError("pass Nmesh to to_mesh")
        if bbox_from_species is None:
            bbox_from_species = 'randoms' if self['randoms'].csize > 0 \
                else 'data'
        box, center = self._define_bbox(position, selection,
                                        bbox_from_species)
        if BoxSize is None:
            BoxSize = box
        if BoxCenter is None:
            BoxCenter = center
        if dtype in ('c16', 'c8'):
            dtype = {'c16': 'f8', 'c8': 'f4'}[dtype]

        return FKPCatalogMesh(self, BoxSize=BoxSize, BoxCenter=BoxCenter,
                              Nmesh=Nmesh, dtype=dtype,
                              selection=selection,
                              comp_weight=comp_weight,
                              fkp_weight=fkp_weight, nbar=nbar,
                              position=position, interlaced=interlaced,
                              compensated=compensated,
                              resampler=resampler)
