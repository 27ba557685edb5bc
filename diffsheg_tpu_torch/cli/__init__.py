"""Command line of the port: ``python -m diffsheg_tpu_torch.cli serve``."""
