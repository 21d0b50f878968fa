"""Algorithms (counterpart of ``nbodykit_tpu/algorithms``)."""

from .fftpower import FFTBase, FFTPower, project_to_basis  # noqa: F401
