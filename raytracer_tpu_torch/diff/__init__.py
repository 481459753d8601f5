"""Differentiable rendering (port of raytracer_tpu/diff/, interior
gradients): `grad` (scene parameters, the scan backend, the inverse
renderer), `tape` (the winner-tape replay intersector) and `bucketed`
(the gradient step whose forward is the tape kernel)."""
