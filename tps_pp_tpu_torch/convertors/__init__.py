from .base import BaseConvertor
from .attn import AttnConvertor

__all__ = ['BaseConvertor', 'AttnConvertor']
