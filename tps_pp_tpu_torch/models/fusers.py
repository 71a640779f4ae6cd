"""``ABIFuser`` (counterpart of ``tps_pp_tpu/models/fusers.py``; reference
fusers/abi_fuser.py:10-51): a sigmoid gate over the two features
concatenated blends them, then ``cls`` reads the blend."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..registry import FUSERS


@FUSERS.register_module()
class ABIFuser(nn.Module):

    def __init__(self, d_model: int = 512, max_seq_len: int = 40,
                 num_chars: int = 90):
        super().__init__()
        self.w_att = nn.Linear(2 * d_model, d_model)
        self.cls = nn.Linear(d_model, num_chars)

    def forward(self, l_feature: torch.Tensor,
                v_feature: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, T, d_model) each -> ``logits`` (N, T, num_chars) and the
        blended ``feature``. The recognizer passes the vision feature as
        ``l_feature``, as the reference does (abinet.py:138)."""
        f_att = torch.sigmoid(self.w_att(torch.cat([l_feature, v_feature],
                                                   dim=2)))
        output = f_att * v_feature + (1 - f_att) * l_feature
        return {'logits': self.cls(output), 'feature': output}
