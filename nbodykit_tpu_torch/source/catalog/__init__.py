"""Catalog sources."""

from .array import ArrayCatalog  # noqa: F401
from .uniform import UniformCatalog  # noqa: F401
