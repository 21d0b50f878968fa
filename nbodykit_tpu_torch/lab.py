"""The single import surface of the port:

    from nbodykit_tpu_torch.lab import *
"""

from . import cosmology, option_scope, set_options, transform  # noqa: F401
from .algorithms import (ConvolvedFFTPower, FFTBase, FFTCorr,  # noqa: F401
                         FFTPower, FKPCatalog, FKPCatalogMesh,
                         FKPWeightFromNbar, ProjectedFFTPower,
                         RedshiftHistogram, project_to_basis)
from .base.catalog import CatalogSource  # noqa: F401
from .base.mesh import Field, FieldMesh, MeshSource  # noqa: F401
from .binned_statistic import BinnedStatistic  # noqa: F401
from .convert import (catalog_from_numpy, field_from_numpy,  # noqa: F401
                      key_from_numpy)
from .cosmology import LinearPower  # noqa: F401
from .pmesh import ParticleMesh  # noqa: F401
from .source.catalog import (ArrayCatalog, LogNormalCatalog,  # noqa: F401
                             MultipleSpeciesCatalog, RandomCatalog,
                             UniformCatalog)
from .source.mesh import (ArrayMesh, CatalogMesh, LinearMesh,  # noqa: F401
                          MultipleSpeciesCatalogMesh)
