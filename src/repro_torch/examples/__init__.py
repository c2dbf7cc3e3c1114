"""Examples of the port, each run as ``python -m
repro_torch.examples.<name>``: the twins of the reference's
``examples/`` scripts."""
