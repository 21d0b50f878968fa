"""HaloCatalog: halos with derived physical columns (counterpart of
``nbodykit_tpu/source/catalog/halos.py``).

Virial mass and radius from the spherical-collapse mean overdensity and
the Dutton & Maccio 2014 concentration-mass relation, computed
analytically from the cosmology's ``Omega_m`` and ``efunc``.
"""

import numpy as np
import torch

from ...base.catalog import CatalogSource, column

RHO_CRIT = 2.7754e11  # (M_sun/h) / (Mpc/h)^3


def halo_mass_definition(mdef, cosmo, redshift):
    """The mean overdensity threshold of a mass definition: 'vir'
    (Bryan & Norman 1998), '200m', '500c', ... ``redshift`` may be a
    scalar or a per-object array; returns numpy f8."""
    om = np.asarray(cosmo.Omega_m(np.asarray(redshift)))
    e2 = np.asarray(cosmo.efunc(np.asarray(redshift))) ** 2
    if mdef == 'vir':
        x = om - 1.0
        delta = 18 * np.pi ** 2 + 82 * x - 39 * x ** 2
        return delta * RHO_CRIT * e2
    mult = float(mdef[:-1])
    kind = mdef[-1]
    if kind == 'm':
        return mult * RHO_CRIT * om * e2
    if kind == 'c':
        return mult * RHO_CRIT * e2
    raise ValueError("unknown mass definition %r" % mdef)


def as_column(x, device):
    """A numpy scalar stays a float; an array becomes an f8 tensor on
    ``device`` (a per-object threshold)."""
    x = np.asarray(x)
    if x.ndim == 0:
        return float(x)
    return torch.as_tensor(x, device=device)


def concentration(mass, redshift):
    """The Dutton & Maccio 2014 c(M, z) of NFW halos."""
    z = np.asarray(redshift, dtype='f8')
    b = as_column(-0.097 + 0.024 * z, mass.device)
    a = as_column(0.537 + (1.025 - 0.537) * np.exp(-0.718 * z ** 1.08),
                  mass.device)
    return 10.0 ** (a + b * torch.log10(mass / 1e12))


class HaloCatalog(CatalogSource):
    """Halos built from a table of (Position, Velocity, Length or Mass),
    on the table's device.

    source : CatalogSource with halo columns; cosmo : Cosmology;
    redshift : float; mdef : mass definition; particle_mass : mass per
    particle, to convert Length into Mass.
    """

    def __init__(self, source, cosmo, redshift, mdef='vir', mass='Mass',
                 position='Position', velocity='Velocity',
                 particle_mass=None):
        CatalogSource.__init__(self, len(source), device=source.device,
                               comm=source.comm)
        self._src = source
        self.cosmo = cosmo
        self.attrs.update(source.attrs)
        self.attrs.update(redshift=redshift, mdef=mdef)
        if particle_mass is not None:
            self.attrs['particle_mass'] = particle_mass
        self._names = dict(mass=mass, position=position, velocity=velocity)

    @column
    def Position(self):
        return self._src[self._names['position']]

    @column
    def Velocity(self):
        return self._src[self._names['velocity']]

    @column
    def Mass(self):
        if self._names['mass'] in self._src:
            return self._src[self._names['mass']]
        if 'Length' in self._src and 'particle_mass' in self.attrs:
            # an integer Length times a float is f8, as under JAX's x64
            return (self._src['Length'].to(torch.float64)
                    * self.attrs['particle_mass'])
        raise ValueError("cannot derive halo masses: need a mass "
                         "column or Length + particle_mass")

    @column
    def Radius(self):
        """The spherical-overdensity radius for attrs['mdef'],
        (3 M / (4 pi Delta rho))^(1/3)."""
        rho = as_column(halo_mass_definition(
            self.attrs['mdef'], self.cosmo, self.attrs['redshift']),
            self.device)
        M = self['Mass']
        return (3.0 * M / (4 * np.pi * rho)) ** (1.0 / 3)

    @column
    def Concentration(self):
        """Dutton & Maccio 2014 c(M, z) of NFW profiles."""
        return concentration(self['Mass'], self.attrs['redshift'])

    @column
    def VelocityOffset(self):
        """Velocity in units of the RSD position offset."""
        z = self.attrs['redshift']
        E = float(self.cosmo.efunc(z))
        return self['Velocity'] * ((1.0 + z) / (100.0 * E))

    def populate(self, model=None, seed=None, **params):
        """Populate the halos with galaxies under an HOD model (an
        :class:`..hod.HODModel`, an occupation instance, or an
        occupation class with its parameters)."""
        from ...hod import HODModel, Zheng07Model
        if model is None:
            model = Zheng07Model(**params)
        elif isinstance(model, type):
            model = model(**params)
        elif params:
            raise ValueError(
                "HOD parameters can only be passed with an occupation "
                "class (got an instance of %s)" % type(model).__name__)
        if not isinstance(model, HODModel):
            model = HODModel(model, seed=seed)
        return model.populate(self, seed=seed)


# PopulatedHaloCatalog is importable from this module, as in the JAX
# package; the class lives with the HOD code to avoid an import cycle
from ...hod import PopulatedHaloCatalog  # noqa: F401,E402
