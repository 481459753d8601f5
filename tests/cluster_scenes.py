"""Scenes of the JAX package's cluster-culling tests
(tests/test_persistent_kernel.py:339-488), built with either package's
SceneBuilder, for the port's clustered-twin tests (CPU) and its kernel-2
culled tests (`cuda`). Imports neither jax nor torch."""

import numpy as np


def grid_6x6(b):
    """tests/test_persistent_kernel.py:339's scene: a 6x6 sphere grid of
    three materials (an emitter among them) on a ground quad."""
    lamb = b.lambertian((0.6, 0.5, 0.4))
    metal = b.metal((0.8, 0.8, 0.8), 0.1)
    light = b.diffuse_light((4.0, 4.0, 4.0))
    mats = [lamb, metal, light]
    for gx in range(6):
        for gz in range(6):
            c = (gx * 2.0 - 5.0, 0.4 + 0.2 * ((gx + gz) % 3), gz * 2.0 - 5.0)
            b.add_sphere(c, 0.35, mats[(gx * 7 + gz) % 3])
    b.add_quad((-20, 0, -20), (40, 0, 0), (0, 0, 40), lamb)
    return b.build(), dict(samples_per_pixel=2, max_depth=6, background=(0.5, 0.6, 0.7),
                           look_from=(0, 6, 14), look_at=(0, 0, 0))


def grid_two_level(b):
    """tests/test_persistent_kernel.py:377's scene: a 10x10 sphere grid and
    an 8x8 quad field, both big enough for a super level at max_leaf 4."""
    lamb = b.lambertian((0.6, 0.5, 0.4))
    mats = [lamb, b.metal((0.8, 0.8, 0.8), 0.05)]
    for gx in range(10):
        for gz in range(10):
            b.add_sphere((gx * 1.5 - 7.0, 0.4, gz * 1.5 - 7.0), 0.3, mats[(gx + gz) % 2])
    for gx in range(8):
        for gz in range(8):
            x0, z0 = gx * 1.8 - 7.2, gz * 1.8 - 7.2
            b.add_quad((x0, 1.6, z0), (0.9, 0, 0), (0, 0, 0.9), lamb)
    return b.build(), dict(samples_per_pixel=1, max_depth=4, background=(0.5, 0.6, 0.7),
                           look_from=(0, 9, 16), look_at=(0, 0, 0))


def image_quad_field(b):
    """tests/test_persistent_kernel.py:449's scene: a 5x5 field of
    image-textured emissive quads (no real sphere)."""
    img = np.random.default_rng(5).uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32)
    light = b.diffuse_light(b.image(img))
    for gx in range(5):
        for gy in range(5):
            x0, y0 = gx * 1.6 - 4.0, gy * 1.6 - 4.0
            b.add_quad((x0, y0, -6.0), (1.2, 0, 0), (0, 1.2, 0), light)
    return b.build(), dict(samples_per_pixel=1, max_depth=3, background=(0.1, 0.2, 0.3),
                           look_from=(0, 0, 4), look_at=(0, 0, -1), fov_degrees=80)


SCENES = {"grid_6x6": grid_6x6, "grid_two_level": grid_two_level,
          "image_quad_field": image_quad_field}
# (scene, cluster_scene arguments, order rows front to back), as JAX's tests.
TWIN_CASES = [
    ("grid_6x6", dict(max_leaf=8), False),
    ("grid_two_level", dict(max_leaf=4, super_fan=4, min_fine_for_super=8), False),
    ("grid_two_level", dict(max_leaf=4, super_fan=4, min_fine_for_super=8), True),
    ("image_quad_field", dict(max_leaf=4), False),
    ("image_quad_field", dict(max_leaf=4, super_fan=2, min_fine_for_super=2), False),
]
