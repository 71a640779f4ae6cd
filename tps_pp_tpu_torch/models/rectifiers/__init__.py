from .moran import MORAN
from .spin import SPIN, generate_beta
from .tps_pp import TPS_PP
from .tps_stn import BasePreprocessor, LocalizationNetwork, TPSPreprocessor

__all__ = ['BasePreprocessor', 'LocalizationNetwork', 'MORAN', 'SPIN',
           'TPS_PP', 'TPSPreprocessor', 'generate_beta']
