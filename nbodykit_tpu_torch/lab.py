"""The single import surface of the port:

    from nbodykit_tpu_torch.lab import *
"""

from . import (cosmology, option_scope, set_options,  # noqa: F401
               setup_logging, timer, transform)
from .algorithms import (ConvolvedFFTPower, FFTBase, FFTCorr,  # noqa: F401
                         FFTPower, FKPCatalog, FKPCatalogMesh,
                         FKPWeightFromNbar, ProjectedFFTPower,
                         RedshiftHistogram, project_to_basis)
from .base.catalog import CatalogSource  # noqa: F401
from .base.mesh import Field, FieldMesh, MeshSource  # noqa: F401
from .binned_statistic import BinnedStatistic  # noqa: F401
from .convert import (catalog_from_numpy, field_from_numpy,  # noqa: F401
                      key_from_numpy)
from .cosmology import (Cosmology, CorrelationFunction,  # noqa: F401
                        FNLGalaxyPower, HalofitPower, LinearNbody,
                        LinearPower, Planck13, Planck15, WMAP5, WMAP7,
                        WMAP9, ZeldovichPower)
from .pmesh import ParticleMesh  # noqa: F401
from .source.catalog import (ArrayCatalog, LogNormalCatalog,  # noqa: F401
                             MultipleSpeciesCatalog, RandomCatalog,
                             UniformCatalog)
from .source.mesh import (ArrayMesh, CatalogMesh, LinearMesh,  # noqa: F401
                          MultipleSpeciesCatalogMesh)
from .algorithms.fof import FOF  # noqa: F401
from .source.catalog.halos import HaloCatalog  # noqa: F401
from .hod import (HODModel, HODModelFactory, Hearin15Model,  # noqa: F401
                  Leauthaud11Model, PopulatedHaloCatalog, Zheng07Model)
from .algorithms.fftrecon import FFTRecon  # noqa: F401
from . import filters, meshtools  # noqa: F401
from .filters import Gaussian, TopHat  # noqa: F401

FKPPower = ConvolvedFFTPower  # the reference's alias
