"""Catalog and mesh base classes (counterpart of ``nbodykit_tpu/base``)."""
