"""Runnable demos of pilosa_tpu_torch (``python -m pilosa_tpu_torch.examples.<name>``)."""
