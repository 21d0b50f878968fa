"""MultipleSpeciesCatalog: several catalogs under one namespace
(counterpart of ``nbodykit_tpu/source/catalog/species.py``).

Columns are addressed as ``"<species>/<column>"``; ``cat[species]``
returns the species' own catalog, so a column set on it is seen through
the container. Each species' attrs appear in the container's attrs as
``"<species>.<key>"``.

With P ranks the species share one mesh of ranks, which the container
takes as its ``comm``; each holds its own rows on every rank.
"""

from ...base.catalog import CatalogSourceBase
from ...parallel.runtime import same_mesh


class MultipleSpeciesCatalog(CatalogSourceBase):
    """A container of named catalogs, all on one device and one mesh of
    ranks (its ``comm``).

    names : list of str, the species names (no '/'); *species : the
    catalogs, one per name.
    """

    def __init__(self, names, *species):
        if len(set(names)) != len(names):
            raise ValueError("species names must be unique")
        if len(names) != len(species):
            raise ValueError("need one name per species catalog")
        if any('/' in name for name in names):
            raise ValueError("species names cannot contain '/'")
        devices = set(str(cat.device) for cat in species)
        if len(devices) > 1:
            raise ValueError("species on different devices: %s"
                             % sorted(devices))

        comm = getattr(species[0], 'comm', None)
        if not all(same_mesh(comm, getattr(cat, 'comm', None))
                   for cat in species[1:]):
            raise ValueError("species on different meshes of ranks: %s"
                             % [getattr(cat, 'comm', None)
                                for cat in species])

        CatalogSourceBase.__init__(self, device=species[0].device,
                                   comm=comm)
        self.attrs['species'] = list(names)
        self._species = dict(zip(names, species))
        for name, cat in self._species.items():
            for k, v in cat.attrs.items():
                self.attrs['%s.%s' % (name, k)] = v

    @property
    def species(self):
        return self.attrs['species']

    @property
    def columns(self):
        out = []
        for name in self.species:
            out += ['%s/%s' % (name, col)
                    for col in self._species[name].columns]
        return sorted(out)

    def __len__(self):
        """The rows of every species on this rank."""
        return sum(len(self._species[name]) for name in self.species)

    @property
    def csize(self):
        """The rows of every species on every rank (a collective when
        there are several)."""
        return sum(self._species[name].csize for name in self.species)

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self.species:
                return self._species[key]
            if '/' in key:
                name, col = key.split('/', 1)
                if name not in self.species:
                    raise KeyError("no species named %r" % name)
                return self._species[name][col]
        raise KeyError("column spec %r; use 'species/column' or a "
                       "species name" % (key,))

    def __setitem__(self, key, value):
        if '/' not in key:
            raise ValueError("set columns as 'species/column'")
        name, col = key.split('/', 1)
        self._species[name][col] = value

    def to_mesh(self, Nmesh=None, BoxSize=None, dtype='f4',
                interlaced=False, compensated=False, resampler='cic',
                position='Position', weight='Weight', value='Value',
                selection='Selection'):
        """A MultipleSpeciesCatalogMesh painting the sum of the
        species."""
        from ..mesh.species import MultipleSpeciesCatalogMesh
        if Nmesh is None:
            Nmesh = self.attrs.get('Nmesh', None)
        if BoxSize is None:
            BoxSize = self.attrs.get('BoxSize', None)
        if Nmesh is None or BoxSize is None:
            raise ValueError("pass Nmesh and BoxSize to to_mesh")
        return MultipleSpeciesCatalogMesh(
            self, Nmesh=Nmesh, BoxSize=BoxSize, dtype=dtype,
            interlaced=interlaced, compensated=compensated,
            resampler=resampler, position=position, weight=weight,
            value=value, selection=selection)
