"""The reference's examples (``examples/``) on the port, run as modules:
``python -m repro_torch.examples.<name>``."""
