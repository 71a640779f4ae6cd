from .base import BaseConvertor
from .attn import AttnConvertor
from .abi import ABIConvertor

__all__ = ['BaseConvertor', 'AttnConvertor', 'ABIConvertor']
