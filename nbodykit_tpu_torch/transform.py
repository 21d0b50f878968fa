"""Column transforms: stacking, concatenation, sky geometry
(counterpart of ``nbodykit_tpu/transform.py``).

Columns are tensors; a numpy or list input is moved to the device of
the first tensor argument, else to the entry points' device (``cuda``
unless the CPU is asked for). The sky conventions are the JAX
package's.
"""

import numpy as np
import torch

from . import resolve_device
from .utils import as_numpy

# ICRS -> galactic rotation (J2000, the IAU matrix of astropy's Galactic
# frame): v_gal = _ICRS_TO_GAL @ v_icrs
_ICRS_TO_GAL = np.array([
    [-0.0548755604162154, -0.8734370902348850, -0.4838350155487132],
    [+0.4941094278755837, -0.4448296299600112, +0.7469822444972189],
    [-0.8676661490190047, -0.1980763734312015, +0.4559837761750669]])


def _device(*arrays):
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device()


def _tensor(x, device, dtype=None):
    """``x`` as a tensor on ``device``; numpy's dtype rules for
    non-tensors (a Python float is f64, as JAX's under x64)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _check_frame(frame):
    if frame not in ('icrs', 'galactic'):
        raise ValueError("frame must be 'icrs' or 'galactic', got %r"
                         % (frame,))


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear between the right-continuous
    bins of the increasing ``xp``, the end values outside it."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + (x - x0) / (xp[i] - x0) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def StackColumns(*cols):
    """Stack 1-D columns into an (N, ncols) tensor."""
    dev = _device(*cols)
    return torch.stack([_tensor(c, dev) for c in cols], dim=-1)


def ConcatenateSources(*sources, **kwargs):
    """Concatenate catalogs along the particle axis: an ArrayCatalog of
    ``columns`` (default: the columns every source has), with the
    sources' attrs merged in order."""
    from .source.catalog.array import ArrayCatalog
    columns = kwargs.get('columns', None)
    if columns is None:
        columns = sources[0].columns
        for s in sources[1:]:
            columns = [c for c in columns if c in s.columns]
    else:
        if isinstance(columns, str):
            columns = [columns]
        for c in columns:
            for s in sources:
                if c not in s.columns:
                    raise ValueError(
                        "cannot concatenate column %r: not in every "
                        "source (available: %s)" % (c, s.columns))
    data = {c: torch.cat([s[c] for s in sources], dim=0) for c in columns}
    attrs = {}
    for s in sources:
        attrs.update(s.attrs)
    return ArrayCatalog(data, device=sources[0].device, **attrs)


def ConstantArray(value, size, chunks=None, device=None):
    """A column of ``size`` copies of ``value`` (a scalar or an
    array); ``chunks`` is accepted for the reference's signature."""
    value = _tensor(value, resolve_device(device))
    return value.expand((int(size),) + tuple(value.shape)).contiguous()


def CartesianToEquatorial(pos, observer=[0, 0, 0], frame='icrs'):
    """Cartesian -> (lon, lat) in degrees in ``frame`` (the galactic
    frame applies the ICRS -> galactic rotation)."""
    _check_frame(frame)
    dev = _device(pos)
    pos = _tensor(pos, dev)
    pos = pos - _tensor(observer, dev, pos.dtype)
    if frame == 'galactic':
        pos = pos @ _tensor(_ICRS_TO_GAL.T, dev, pos.dtype)
    s = torch.hypot(pos[..., 0], pos[..., 1])
    lon = torch.remainder(torch.rad2deg(torch.atan2(pos[..., 1],
                                                    pos[..., 0])), 360.0)
    lat = torch.rad2deg(torch.atan2(pos[..., 2], s))
    return lon, lat


def SkyToUnitSphere(ra, dec, degrees=True):
    """(RA, Dec) -> (N, 3) unit vectors."""
    dev = _device(ra, dec)
    ra = _tensor(ra, dev)
    dec = _tensor(dec, dev)
    if degrees:
        ra = torch.deg2rad(ra)
        dec = torch.deg2rad(dec)
    x = torch.cos(dec) * torch.cos(ra)
    y = torch.cos(dec) * torch.sin(ra)
    z = torch.sin(dec)
    return torch.stack([x, y, z], dim=-1)


def SkyToCartesian(ra, dec, redshift, cosmo, observer=[0, 0, 0],
                   degrees=True, frame='icrs'):
    """(lon, lat, z) -> comoving Cartesian in Mpc/h; with
    ``frame='galactic'`` (lon, lat) are galactic and the result is
    ICRS-aligned. The distances come from ``cosmo`` on the host."""
    _check_frame(frame)
    pos = SkyToUnitSphere(ra, dec, degrees=degrees)
    if frame == 'galactic':
        pos = pos @ _tensor(_ICRS_TO_GAL, pos.device, pos.dtype)
    r = _tensor(cosmo.comoving_distance(as_numpy(redshift)), pos.device)
    return r[..., None] * pos + _tensor(observer, pos.device, pos.dtype)


def CartesianToSky(pos, cosmo, velocity=None, observer=[0, 0, 0],
                   zmax=100.0, frame='icrs'):
    """Cartesian -> (RA, Dec, z): z inverted from the comoving distance
    on a grid out to ``zmax``; with ``velocity``, the observed redshift
    including the line-of-sight peculiar velocity."""
    _check_frame(frame)
    dev = _device(pos)
    pos = _tensor(pos, dev)
    pos = pos - _tensor(observer, dev, pos.dtype)
    ra, dec = CartesianToEquatorial(pos, frame=frame)
    r = torch.sqrt((pos ** 2).sum(dim=-1))

    zgrid = np.concatenate([[0.0], np.logspace(-8, np.log10(zmax), 1024)])
    rgrid = np.asarray(cosmo.comoving_distance(zgrid))
    z = _interp(r, _tensor(rgrid, dev, r.dtype),
                _tensor(zgrid, dev, r.dtype))

    if velocity is not None:
        velocity = _tensor(velocity, dev)
        rhat = pos / torch.where(r == 0, 1.0, r)[..., None]
        vpec = (velocity * rhat).sum(dim=-1)
        z = z + vpec / 299792.458 * (1 + z)
    return ra, dec, z


def VectorProjection(vector, direction):
    """The projection of ``vector`` onto ``direction``."""
    dev = _device(vector, direction)
    vector = _tensor(vector, dev)
    direction = _tensor(direction, dev, vector.dtype)
    direction = direction / torch.sqrt(
        (direction ** 2).sum(dim=-1, keepdim=True))
    amp = (vector * direction).sum(dim=-1, keepdim=True)
    return amp * direction


# halo properties, analytic (the JAX package's counterparts of the
# reference's halotools transforms)

def HaloRadius(mass, cosmo, redshift, mdef='vir'):
    """Spherical-overdensity radius (Mpc/h) of halo masses (M_sun/h)."""
    from .source.catalog.halos import as_column, halo_mass_definition
    mass = _tensor(mass, _device(mass))
    rho = as_column(halo_mass_definition(mdef, cosmo, redshift),
                    mass.device)
    return (3.0 * mass / (4 * np.pi * rho)) ** (1.0 / 3)


def HaloConcentration(mass, cosmo, redshift, mdef='vir'):
    """The Dutton & Maccio 2014 concentration-mass relation."""
    from .source.catalog.halos import concentration
    return concentration(_tensor(mass, _device(mass)), redshift)


def HaloVelocityDispersion(mass, cosmo, redshift, mdef='vir'):
    """Virial velocity dispersion in km/s: sigma^2 ~ G M / (2 R)."""
    G = 4.302e-9  # Mpc (km/s)^2 / M_sun (with h's cancelling)
    mass = _tensor(mass, _device(mass))
    R = HaloRadius(mass, cosmo, redshift, mdef)
    return torch.sqrt(G * mass / (2.0 * R))
