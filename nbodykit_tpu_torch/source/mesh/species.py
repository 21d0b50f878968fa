"""MultipleSpeciesCatalogMesh: paint the sum of several species
(counterpart of ``nbodykit_tpu/source/mesh/species.py``).

Each species is painted with its own columns onto the same mesh; the
sum is normalized by the combined weighted number per cell (1 + delta
of all species together). With P ranks each species is painted across
the ranks (its paint attrs, N and W among them, are totals over the
ranks), so the normalization is the same on every rank.
"""

from ...base.mesh import Field, MeshSource
from .catalog import CatalogMesh


class MultipleSpeciesCatalogMesh(MeshSource):
    """Mesh view of a MultipleSpeciesCatalog; ``mesh[species]`` gives
    the single-species CatalogMesh."""

    def __init__(self, source, Nmesh, BoxSize, dtype='f4',
                 interlaced=False, compensated=False, resampler='cic',
                 position='Position', weight='Weight', value='Value',
                 selection='Selection'):
        self.source = source
        attrs = dict(source.attrs)
        attrs.update(getattr(self, 'attrs', {}))  # a subclass's pre-set wins
        self.attrs = attrs
        MeshSource.__init__(self, Nmesh, BoxSize, dtype=dtype,
                            device=source.device, comm=source.comm)
        self.interlaced = interlaced
        self.compensated = compensated
        self.resampler = resampler
        self.position = position
        self.weight = weight
        self.value = value
        self.selection = selection

    def __getitem__(self, species):
        if species not in self.source.species:
            raise KeyError("species %r not in %s" % (species,
                                                     self.source.species))
        return CatalogMesh(
            self.source[species], Nmesh=self.attrs['Nmesh'],
            BoxSize=self.attrs['BoxSize'], dtype=self.pm.dtype,
            interlaced=self.interlaced, compensated=self.compensated,
            resampler=self.resampler, position=self.position,
            weight=self.weight, value=self.value, selection=self.selection)

    def to_real_field(self):
        """Sum of the unnormalized species paints over the total
        weighted number per cell; attrs gain each species' paint attrs
        as ``"<species>.<key>"`` and the totals N, W, num_per_cell."""
        total = None
        attrs = {}
        Wsum = 0.0
        Nsum = 0.0
        for name in self.source.species:
            f = self[name].to_real_field(normalize=False)
            for k, v in f.attrs.items():
                attrs['%s.%s' % (name, k)] = v
            Wsum += f.attrs['W']
            Nsum += f.attrs['N']
            if total is None:
                total = f.value
            else:
                total += f.value
            del f
        nbar = Wsum / self.pm.Ntot
        if nbar > 0:
            total /= nbar
        attrs['N'] = Nsum
        attrs['W'] = Wsum
        attrs['num_per_cell'] = nbar
        return Field(total, self.pm, 'real', attrs)
