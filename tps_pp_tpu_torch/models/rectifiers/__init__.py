from .tps_pp import TPS_PP
from .tps_stn import BasePreprocessor, LocalizationNetwork, TPSPreprocessor

__all__ = ['BasePreprocessor', 'LocalizationNetwork', 'TPS_PP',
           'TPSPreprocessor']
