"""LogNormalCatalog: lognormal + Zel'dovich mock galaxy catalog
(counterpart of ``nbodykit_tpu/source/catalog/lognormal.py``).

Reference: ``nbodykit/source/catalog/lognormal.py:9`` (`_makesource`
:137-190): Gaussian delta and displacement fields from a linear power
spectrum, lognormal transform with bias, Poisson sampling, Zel'dovich
position update, linear velocities v = f a H psi. The draws are the JAX
package's: a seed gives its catalog.
"""

import numpy as np
import torch

from ...base.catalog import CatalogSource, column
from ...pmesh import ParticleMesh
from ... import mockmaker
from ...parallel.runtime import CurrentMesh, require_one_rank


class LogNormalCatalog(CatalogSource):
    """Poisson-sampled lognormal realization of a linear power spectrum,
    with Zel'dovich displacements and velocities.

    Parameters
    ----------
    Plin : callable P(k) (called on a tensor of |k|); if it carries
        ``cosmo``/``redshift`` attributes (like LinearPower), they set
        the growth rate for velocities
    nbar : mean number density, in (box units)^-3
    BoxSize, Nmesh : mesh geometry
    bias : lognormal bias b (delta_g = exp(b delta) - 1)
    seed : realization seed
    cosmo, redshift : override Plin's attributes
    dtype : mesh dtype ('f4' or 'f8'); the columns are f32 either way
    comm : the mesh of ranks (default: the ambient one); one rank only,
        as the Poisson draw is not ported across ranks
    device : 'cuda' (default) or 'cpu'

    The fields live one at a time where they can: delta_k stays while
    delta becomes lam in place, the Poisson draw yields the occupied
    cells alone, then each displacement component is transformed, read at
    the particles' cells and freed.
    """

    def __init__(self, Plin, nbar, BoxSize, Nmesh, bias=2.0, seed=None,
                 cosmo=None, redshift=None, unitary_amplitude=False,
                 inverted_phase=False, dtype='f4', comm=None,
                 device=None):
        require_one_rank(CurrentMesh.resolve(comm), 'LogNormalCatalog')
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)

        cosmo = cosmo if cosmo is not None else getattr(Plin, 'cosmo', None)
        redshift = redshift if redshift is not None else \
            getattr(Plin, 'redshift', None)

        self._pm = ParticleMesh(Nmesh, BoxSize, dtype=dtype, device=device,
                                comm=comm)
        pm = self._pm

        delta_k, _ = mockmaker.gaussian_complex_fields(
            pm, Plin, seed, unitary_amplitude=unitary_amplitude,
            inverted_phase=inverted_phase)
        stage = mockmaker.stage
        with stage('c2r_delta'):
            delta = pm.c2r(delta_k.value)
        with stage('lambda'):
            lam = mockmaker.lognormal_lambda(delta, pm, nbar, bias)
        del delta
        with stage('poisson'):
            cells, counts, ntot = mockmaker.poisson_cells(
                lam, seed, expected=nbar * float(np.prod(pm.BoxSize)))
        del lam
        with stage('points'):
            cell_ids, pos = mockmaker.cell_points(pm, cells, counts, ntot,
                                                  seed)
        del cells, counts
        with stage('displacement_c2r_gather'):
            psi = torch.empty((ntot, 3), dtype=torch.float32,
                              device=pm.device)
            for axis in range(3):
                real = pm.c2r_natural(mockmaker.displacement_component(
                    pm, delta_k.value, axis))
                psi[:, axis] = real.reshape(-1)[cell_ids]
                del real
        del delta_k, cell_ids

        # velocities: v = f * a * H(a) * psi = f * 100 * E(z) / (1+z) psi
        if cosmo is not None and redshift is not None:
            f = float(cosmo.scale_independent_growth_rate(redshift))
            E = float(cosmo.efunc(redshift))
            vfac = f * 100.0 * E / (1.0 + redshift)
        else:
            f = 0.0
            vfac = 0.0

        # Zel'dovich update: x -> x + psi (periodic wrap)
        with stage('zeldovich'):
            box = torch.as_tensor(pm.BoxSize, dtype=torch.float32,
                                  device=pm.device)
            self._pos = torch.remainder(pos + psi, box)
            self._vel = psi * vfac
            self._voff = psi * f  # f * psi, Mpc/h
        del pos, psi

        CatalogSource.__init__(self, ntot, device=pm.device, comm=comm)
        self.attrs['BoxSize'] = pm.BoxSize.copy()
        self.attrs['Nmesh'] = pm.Nmesh.copy()
        self.attrs.update(nbar=nbar, bias=bias, seed=seed)
        if redshift is not None:
            self.attrs['redshift'] = redshift
        if hasattr(Plin, 'attrs'):
            self.attrs.update({k: v for k, v in Plin.attrs.items()
                               if k not in self.attrs})

        self._cosmo = cosmo

    @column
    def Position(self):
        return self._pos

    @column
    def Velocity(self):
        return self._vel

    @column
    def VelocityOffset(self):
        """RSD position offset f * psi in Mpc/h, so that
        x_rsd = x + VelocityOffset . los (reference convention,
        lognormal.py:189)."""
        return self._voff

    def __repr__(self):
        return "LogNormalCatalog(size=%d, seed=%s)" % (
            self.size, self.attrs['seed'])
