"""The single import surface of the port:

    from nbodykit_tpu_torch.lab import *
"""

from . import option_scope, set_options  # noqa: F401
from .algorithms import FFTBase, FFTPower, project_to_basis  # noqa: F401
from .base.catalog import CatalogSource  # noqa: F401
from .base.mesh import Field, FieldMesh, MeshSource  # noqa: F401
from .binned_statistic import BinnedStatistic  # noqa: F401
from .convert import catalog_from_numpy, field_from_numpy  # noqa: F401
from .pmesh import ParticleMesh  # noqa: F401
from .source.catalog import ArrayCatalog, UniformCatalog  # noqa: F401
from .source.mesh import CatalogMesh  # noqa: F401
