"""Differentiable forward model (counterpart of
``nbodykit_tpu/forward``): LPT initial conditions, a symplectic PM
stepper, and field-level inference, each a function of the linear modes
that ``torch.autograd`` differentiates end to end.

  lpt.py      Zel'dovich + 2LPT displacements from the linear modes,
              by the spectral gradient of the inverse Laplacian.
  adjoint.py  grad-safe paint: native autograd through the scatter
              paint, or a ``torch.autograd.Function`` whose backward is
              the readout (scatter's adjoint).
  pm.py       kick-drift-kick PM stepper; ``ForwardModel`` is the
              modes -> density map.
  infer.py    Gaussian field-level posterior and gradient-descent
              recovery of the initial field, FFTRecon as the baseline.
"""

from .lpt import (linear_amplitude, linear_modes, modes_from_white,
                  lpt_displacements, lpt_init)
from .adjoint import resolve_forward_paint, make_paint
from .pm import (ForwardModel, GrowthTable, dkick, ddrift,
                 power_law, normalized_amplitude)
from .infer import (binned_power, cross_correlation,
                    mean_cross_correlation, make_loss, linear_init,
                    recover, fftrecon_baseline)

__all__ = [
    'linear_amplitude', 'linear_modes', 'modes_from_white',
    'lpt_displacements', 'lpt_init',
    'resolve_forward_paint', 'make_paint',
    'ForwardModel', 'GrowthTable', 'dkick', 'ddrift', 'power_law',
    'normalized_amplitude',
    'binned_power', 'cross_correlation', 'mean_cross_correlation',
    'make_loss', 'linear_init', 'recover', 'fftrecon_baseline',
]
