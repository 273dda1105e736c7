"""Command-line tools of the port (``python -m mm_training_tpu_torch.scripts.<name>``)."""
