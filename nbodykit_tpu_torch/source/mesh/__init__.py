"""Mesh sources."""

from .array import ArrayMesh  # noqa: F401
from .catalog import CatalogMesh  # noqa: F401
from .linear import LinearMesh  # noqa: F401
from .species import MultipleSpeciesCatalogMesh  # noqa: F401
