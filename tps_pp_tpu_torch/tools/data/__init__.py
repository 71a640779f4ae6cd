"""The dataset converters (``python -m tps_pp_tpu_torch.tools.data.<name>``;
counterparts of ``tools/data/*.py``)."""
