"""Catalog and mesh sources (counterpart of ``nbodykit_tpu/source``)."""
