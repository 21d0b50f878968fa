"""Fourier-space mesh filters (counterpart of ``nbodykit_tpu/filters.py``).

Each is a :class:`~.base.mesh.MeshFilter`, so ``mesh.apply(flt)`` takes
its coordinate kind and field mode from the filter."""

import torch

from .base.mesh import MeshFilter


class TopHat(MeshFilter):
    """Spherical top-hat smoothing of radius r: multiplies delta_k by
    the Fourier window 3 (sin x - x cos x) / x^3, x = k r."""

    kind = 'wavenumber'
    mode = 'complex'

    def __init__(self, r):
        self.r = r

    def filter(self, k, v):
        k2 = sum(ki ** 2 for ki in k)
        kr = torch.sqrt(k2) * self.r
        krs = torch.where(kr == 0, 1.0, kr)
        w = 3.0 * (torch.sin(krs) - krs * torch.cos(krs)) / krs ** 3
        w = torch.where(kr == 0, 1.0, w)
        return v * w


class Gaussian(MeshFilter):
    """Gaussian smoothing of width r: multiplies delta_k by
    exp(-(k r)^2 / 2)."""

    kind = 'wavenumber'
    mode = 'complex'

    def __init__(self, r):
        self.r = r

    def filter(self, k, v):
        k2 = sum(ki ** 2 for ki in k)
        return v * torch.exp(-0.5 * k2 * self.r ** 2)
