"""FKPCatalogMesh: the FKP density field (counterpart of
``nbodykit_tpu/algorithms/convpower/catalogmesh.py``).

F(x) = [w n_data(x) - alpha w n_randoms(x)] / cell volume, with w the
completeness weight times the FKP weight and the positions re-centred
on the box, each species painted unnormalized through the port's
paint. With P ranks each species is painted across the ranks and every
sum is a total over them.
"""

import numpy as np
import torch

from ...base.mesh import Field
from ...source.mesh.catalog import CatalogMesh
from ...source.mesh.species import MultipleSpeciesCatalogMesh
from ...parallel.runtime import mesh_size
from ...utils import stage


class FKPCatalogMesh(MultipleSpeciesCatalogMesh):
    """The mesh of an :class:`FKPCatalog` (made by its ``to_mesh``)."""

    def __init__(self, source, BoxSize, BoxCenter, Nmesh, dtype,
                 selection, comp_weight, fkp_weight, nbar, value='Value',
                 position='Position', interlaced=False, compensated=False,
                 resampler='cic'):
        from .catalog import FKPCatalog
        if not isinstance(source, FKPCatalog):
            raise TypeError("FKPCatalogMesh requires an FKPCatalog")

        self.attrs = dict(source.attrs)
        self.attrs['BoxSize'] = np.ones(3) * BoxSize
        self.attrs['BoxCenter'] = np.ones(3) * BoxCenter

        self._uncentered_position = position
        self.comp_weight = comp_weight
        self.fkp_weight = fkp_weight
        self.nbar = nbar

        MultipleSpeciesCatalogMesh.__init__(
            self, source=source, BoxSize=BoxSize, Nmesh=Nmesh,
            dtype=dtype, weight='_TotalWeight', value=value,
            selection=selection, position='_RecenteredPosition',
            interlaced=interlaced, compensated=compensated,
            resampler=resampler)

    def RecenteredPosition(self, name):
        """Positions less BoxCenter, in [-L/2, L/2)."""
        pos = self.source[name][self._uncentered_position]
        center = torch.as_tensor(self.attrs['BoxCenter'], dtype=pos.dtype,
                                 device=pos.device)
        return pos - center

    def TotalWeight(self, name):
        """Completeness weight times FKP weight."""
        return (self.source[name][self.comp_weight]
                * self.source[name][self.fkp_weight])

    def weighted_total(self, name):
        """W: the sum of the selected completeness weights (over every
        rank's rows)."""
        cat = self.source[name]
        w = torch.where(cat[self.selection], cat[self.comp_weight],
                        0.0).sum().reshape(1)
        if mesh_size(self.pm.comm) > 1:
            w = self.pm.comm.all_reduce(w)
        return float(w)

    def __getitem__(self, species):
        """The CatalogMesh of one species, painting its re-centred
        positions (shifted by L/2 onto the mesh's [0, L)) with the total
        weight, on a view of the species catalog."""
        if species not in self.source.species:
            raise KeyError(species)
        view = self.source[species].view()
        pos = self.RecenteredPosition(species)
        pos += torch.as_tensor(self.attrs['BoxSize'] / 2.0,
                               dtype=pos.dtype, device=pos.device)
        view['_RecenteredPosition'] = pos
        view['_TotalWeight'] = self.TotalWeight(species)
        return CatalogMesh(
            view, Nmesh=self.attrs['Nmesh'], BoxSize=self.attrs['BoxSize'],
            dtype=self.pm.dtype, interlaced=self.interlaced,
            compensated=self.compensated, resampler=self.resampler,
            position='_RecenteredPosition', weight='_TotalWeight',
            value=self.value, selection=self.selection)

    def to_real_field(self):
        """The FKP density field in number-density units; attrs carry
        alpha, each species' W and its paint attrs as
        ``"<species>.<key>"`` (shot noise dropped)."""
        attrs = {}
        for name in self.source.species:
            attrs[name + '.W'] = self.weighted_total(name)
        attrs['alpha'] = attrs['data.W'] / attrs['randoms.W'] \
            if attrs['randoms.W'] > 0 else 1.0

        with stage('paint_data'):
            data_field = self['data'].to_real_field(normalize=False)
        for k, v in data_field.attrs.items():
            attrs['data.' + k] = v
        total = data_field.value
        del data_field

        if self.source['randoms'].csize > 0:
            with stage('paint_randoms'):
                ran_field = self['randoms'].to_real_field(normalize=False)
            for k, v in ran_field.attrs.items():
                attrs['randoms.' + k] = v
            ran = ran_field.value
            del ran_field
            ran *= attrs['alpha']
            total -= ran
            del ran

        vol_per_cell = float(np.prod(self.attrs['BoxSize'] /
                                     self.attrs['Nmesh']))
        total /= vol_per_cell
        attrs.pop('data.shotnoise', None)
        attrs.pop('randoms.shotnoise', None)
        return Field(total, self.pm, 'real', attrs)
