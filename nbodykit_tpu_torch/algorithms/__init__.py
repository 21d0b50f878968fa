"""Algorithms (counterpart of ``nbodykit_tpu/algorithms``)."""

from .convpower import (ConvolvedFFTPower, FKPCatalog,  # noqa: F401
                        FKPCatalogMesh, FKPWeightFromNbar, get_real_Ylm)
from .fftcorr import FFTCorr  # noqa: F401
from .fftpower import (FFTBase, FFTPower, ProjectedFFTPower,  # noqa: F401
                       project_to_basis)
from .zhist import RedshiftHistogram, scotts_bin_width  # noqa: F401
