"""Catalog sources."""

from .array import ArrayCatalog  # noqa: F401
from .lognormal import LogNormalCatalog  # noqa: F401
from .uniform import RandomCatalog, UniformCatalog  # noqa: F401
from .species import MultipleSpeciesCatalog  # noqa: F401
