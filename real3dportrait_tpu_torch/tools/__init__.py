"""Command-line tools of the port (``python -m real3dportrait_tpu_torch.tools.<name>``)."""
