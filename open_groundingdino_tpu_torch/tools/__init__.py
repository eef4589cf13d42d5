"""Command-line tools of the port (run with `python -m open_groundingdino_tpu_torch.tools.<name>`)."""
