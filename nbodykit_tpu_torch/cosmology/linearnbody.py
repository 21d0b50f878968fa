"""LinearNbody: linear-theory evolution of an N-body particle system (a copy of
``nbodykit_tpu/cosmology/linearnbody.py``).

Reference: ``nbodykit/cosmology/linearnbody.py:5`` — evolve particle
displacements/velocities with the linear growth solution (useful for
initializing or rewinding simulations):

    x(a2) = q + D1(a2)/D1(a1) (x(a1) - q)
    v     = a^2 H(a) dD1/da * psi

``integrate`` scales numpy arrays or torch tensors in place of the
JAX package's arrays; a tensor stays on its device.
"""

from .background import MatterDominated


class LinearNbody(object):
    """Scale particle displacements and momenta by linear growth.

    Parameters
    ----------
    cosmo : Cosmology
    """

    def __init__(self, cosmo):
        self.cosmo = cosmo
        self._pt = MatterDominated(
            Omega0_m=cosmo.Omega0_m,
            Omega0_lambda=cosmo.Omega0_lambda,
            Omega0_k=cosmo.Omega0_k)

    def integrate(self, q, disp, vel, a1, a2):
        """Evolve (positions-from-lattice ``disp``, velocities) from
        scale factor a1 to a2 in linear theory.

        Returns (disp2, vel2): disp scales with D1, velocity with the
        1LPT momentum growth Gp = a^2 E D1 f1.
        """
        pt = self._pt
        g1 = float(pt.D1(a1))
        g2 = float(pt.D1(a2))
        ratio = g2 / g1
        disp2 = disp * ratio
        vfac2 = float(a2 ** 2 * pt.E(a2) * pt.f1(a2) * 100.0) * g2 / g1
        vfac1 = float(a1 ** 2 * pt.E(a1) * pt.f1(a1) * 100.0)
        # scale velocities consistently with the displacement growth
        vel2 = vel * (vfac2 / vfac1)
        return disp2, vel2
