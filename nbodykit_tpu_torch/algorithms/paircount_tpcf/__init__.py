"""Correlation functions from pair counts (counterpart of
``nbodykit_tpu/algorithms/paircount_tpcf``)."""

from .tpcf import SimulationBox2PCF, SurveyData2PCF

__all__ = ['SimulationBox2PCF', 'SurveyData2PCF']
