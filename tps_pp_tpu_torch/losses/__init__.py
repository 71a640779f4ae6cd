from .abi import ABILoss, masked_ce_by_length
from .ce import CELoss, TFLoss, masked_ce

__all__ = ['ABILoss', 'CELoss', 'TFLoss', 'masked_ce', 'masked_ce_by_length']
