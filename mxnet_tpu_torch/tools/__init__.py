"""Command-line tools of the port, run as ``python -m
mxnet_tpu_torch.tools.<name>``."""
