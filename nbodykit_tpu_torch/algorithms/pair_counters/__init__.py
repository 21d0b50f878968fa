"""Pair counting (counterpart of ``nbodykit_tpu/algorithms/pair_counters``),
single-device: the JAX package's domain-decomposed driver waits for the
multi-GPU port."""

from .mocksurvey import SurveyDataPairCount
from .simbox import SimulationBoxPairCount

__all__ = ['SimulationBoxPairCount', 'SurveyDataPairCount']
