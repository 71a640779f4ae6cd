from .tps_pp import TPS_PP

__all__ = ['TPS_PP']
