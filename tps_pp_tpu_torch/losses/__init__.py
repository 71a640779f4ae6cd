from .ce import CELoss, TFLoss, masked_ce

__all__ = ['CELoss', 'TFLoss', 'masked_ce']
