"""Command-line tools of the port (``python -m clip_for_dl_tpu_torch.tools.<name>``)."""
