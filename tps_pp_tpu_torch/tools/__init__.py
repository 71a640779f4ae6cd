"""Command-line entry points of the port (``python -m
tps_pp_tpu_torch.tools.<name>``)."""
