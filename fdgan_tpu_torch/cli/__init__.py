"""Command-line entry points (``python -m fdgan_tpu_torch.cli.serve``)."""
