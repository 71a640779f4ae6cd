from .abi import ABILoss, masked_ce_by_length
from .ce import CELoss, SARLoss, TFLoss, masked_ce
from .ctc import CTCLoss

__all__ = ['ABILoss', 'CELoss', 'CTCLoss', 'SARLoss', 'TFLoss', 'masked_ce',
           'masked_ce_by_length']
