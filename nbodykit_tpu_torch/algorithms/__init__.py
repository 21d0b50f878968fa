"""Algorithms (counterpart of ``nbodykit_tpu/algorithms``)."""

from .convpower import (ConvolvedFFTPower, FKPCatalog,  # noqa: F401
                        FKPCatalogMesh, FKPWeightFromNbar, get_real_Ylm)
from .fftcorr import FFTCorr  # noqa: F401
from .fftpower import (FFTBase, FFTPower, ProjectedFFTPower,  # noqa: F401
                       project_to_basis)
from .zhist import RedshiftHistogram, scotts_bin_width  # noqa: F401
from .pair_counters import (SimulationBoxPairCount,  # noqa: F401
                            SurveyDataPairCount)
from .paircount_tpcf import SimulationBox2PCF, SurveyData2PCF  # noqa: F401
from .threeptcf import SimulationBox3PCF, SurveyData3PCF  # noqa: F401
from .kdtree import KDDensity  # noqa: F401
from .cgm import CylindricalGroups  # noqa: F401
from .fibercollisions import FiberCollisions  # noqa: F401
from .bispectrum import Bispectrum  # noqa: F401
