"""Sharded rendering and training over torch.distributed (port of
raytracer_tpu/parallel/)."""
