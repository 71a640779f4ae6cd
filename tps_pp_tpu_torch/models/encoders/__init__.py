from .nrtr import NRTREncoder

__all__ = ['NRTREncoder']
