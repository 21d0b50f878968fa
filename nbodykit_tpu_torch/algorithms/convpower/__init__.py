"""Survey power-spectrum multipoles (counterpart of
``nbodykit_tpu/algorithms/convpower``)."""

from .catalog import FKPCatalog, FKPWeightFromNbar
from .catalogmesh import FKPCatalogMesh
from .fkp import ConvolvedFFTPower, get_real_Ylm

__all__ = ['ConvolvedFFTPower', 'FKPCatalog', 'FKPCatalogMesh',
           'FKPWeightFromNbar', 'get_real_Ylm']
