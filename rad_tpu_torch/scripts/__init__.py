"""Command lines of the port: ``python -m rad_tpu_torch.scripts.<name>``."""
