"""Config tools (``python -m tps_pp_tpu_torch.tools.misc.<name>``;
counterparts of ``tools/misc/*.py``)."""
