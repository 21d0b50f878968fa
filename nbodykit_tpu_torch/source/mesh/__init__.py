"""Mesh sources."""

from .catalog import CatalogMesh  # noqa: F401
