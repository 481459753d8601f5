"""Command-line demonstrations of the port (`python -m
raytracer_tpu_torch.scripts.<name>`)."""
