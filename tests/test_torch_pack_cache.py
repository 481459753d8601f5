"""render/driver.py:chunk_renderer's cache of packed tables: a second
render of the same scene, camera and settings takes its tables from the
cache and renders the image a fresh pack renders, bit for bit; an edited
or replaced tensor, another camera or other settings pack anew; tensors
that require grad and an explicit cluster table bypass it; a clustered
hit keeps the metrics truthful; the cache is bounded; and no render writes
into a cached table. One `cuda`-marked test counts the syncs and copies of
a cached pack on the card; this file imports no JAX, so it runs there as
it is:

    python -m pytest --noconftest -o markers="cuda: needs a CUDA device" \\
        -m cuda tests/test_torch_pack_cache.py
"""

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch.geometry import bvh as pbvh
from raytracer_tpu_torch.render import driver
from raytracer_tpu_torch.render.driver import chunk_renderer, clear_pack_cache, render_image
from raytracer_tpu_torch.scenes import builders
from raytracer_tpu_torch.scenes.registry import get_scene
from raytracer_tpu_torch.utils import trace
from raytracer_tpu_torch.utils.metrics import RenderMetrics

torch.set_num_threads(1)

CPU = torch.device("cpu")
# One scene of each kind of pack: plain tables on the persistent path,
# image textures (their stochastic bilinear tap), and the wavefront-step
# path's rng-filled Perlin tables.
SCENES = {
    "rand_spheres": lambda: get_scene("rand_spheres", width=16, spp=2, max_depth=4),
    "earth": lambda: get_scene("earth", width=16, spp=2, max_depth=4, bilinear=True,
                               tex_height=8, tex_width=16),
    "rng_perlin": lambda: get_scene("perlin", width=8, spp=2, max_depth=3,
                                    procedural_perlin=False),
}


@pytest.fixture(autouse=True)
def empty_cache():
    """Every test starts and ends with an empty pack cache."""
    clear_pack_cache()
    yield
    clear_pack_cache()


def render(scene, cam, st, seed=7, **kw):
    return render_image(scene, cam, st, device="cpu", seed=seed, **kw)


def fresh(scene, cam, st, seed=7, **kw):
    """The image of a render with an empty cache (the cache emptied after)."""
    clear_pack_cache()
    img = render(scene, cam, st, seed, **kw)
    clear_pack_cache()
    return img


def pack_counts(fn):
    """(fn(), the counters of each `render/pack` span opened inside fn)."""
    trace.collect()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, [s["counts"] for s in trace.collect() if s["name"] == "render/pack"]


def renderer_tensors(renderer) -> list:
    """Every tensor a ChunkRenderer hands the kernels."""
    out = [*renderer.tables, renderer.cam_scalars]
    if renderer.textures is not None:
        t = renderer.textures
        out += [t.rows, t.images, t.image_dims, *(t.perlin or ())]
    if renderer.clusters is not None:
        out.append(renderer.clusters.rows)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_a_second_render_hits_and_equals_a_fresh_render(name):
    """The second render of one scene finds its pack in the cache (one
    pack_hits, where the first counted one pack_misses), and its image is
    bit-equal to one rendered after the cache was emptied."""
    scene, cam, st = SCENES[name]()
    (_, img), counts = pack_counts(lambda: (render(scene, cam, st, seed=3),
                                            render(scene, cam, st)))
    assert counts == [{"pack_misses": 1}, {"pack_hits": 1}]
    assert chunk_renderer(scene, cam, st, CPU) is chunk_renderer(scene, cam, st, CPU)
    assert torch.equal(img, fresh(scene, cam, st))


@pytest.mark.parametrize("edit", ["sph_center", "mat_albedo"])
def test_an_in_place_edit_misses_and_renders_the_edited_scene(edit):
    """A sphere centre or a material albedo edited in place (as torch.optim
    moves a leaf) bumps its version: the next render packs anew, renders
    the edited scene as a fresh render does, and differs from the first."""
    scene, cam, st = SCENES["rand_spheres"]()
    before = render(scene, cam, st)
    with torch.no_grad():
        if edit == "sph_center":
            scene.sph_center[:, 1] += 0.25
        else:
            scene.mat_albedo.mul_(0.5)
    got, counts = pack_counts(lambda: render(scene, cam, st))
    assert counts == [{"pack_misses": 1}]
    assert torch.equal(got, fresh(scene, cam, st))
    assert not torch.equal(got, before)


def test_a_replaced_tensor_misses():
    """dataclasses.replace with a new texture colour tensor (the other 22
    tensors the same objects) packs anew and renders its own colours."""
    scene, cam, st = SCENES["rand_spheres"]()
    before = render(scene, cam, st)
    dark = dataclasses.replace(scene, tex_c0=torch.zeros_like(scene.tex_c0))
    got, counts = pack_counts(lambda: render(dark, cam, st))
    assert counts == [{"pack_misses": 1}]
    assert torch.equal(got, fresh(dark, cam, st))
    assert not torch.equal(got, before)


def test_a_camera_change_keeps_the_scene_tables():
    """A moved camera over the same scene repacks the camera scalars alone:
    the sphere, quad, primitive and texture tables are the cached objects,
    and the image equals a fresh render."""
    scene, cam, st = SCENES["earth"]()
    first = chunk_renderer(scene, cam, st, CPU)
    moved = dataclasses.replace(cam, look_from=cam.look_from + torch.tensor([1.0, 0.5, 0.0]))
    second = chunk_renderer(scene, moved, st, CPU)
    assert second is not first and second.textures is first.textures
    assert all(a is b for a, b in zip(second.tables, first.tables))
    assert not torch.equal(second.cam_scalars, first.cam_scalars)
    got, counts = pack_counts(lambda: render(scene, moved, st))
    assert counts == [{"pack_hits": 1}]
    assert torch.equal(got, fresh(scene, moved, st))


@pytest.mark.parametrize("change", ["width", "height", "max_depth", "sky_gradient",
                                    "bilinear_stochastic"])
def test_a_settings_change_misses(change):
    """Another width, height, depth, sky or image filter packs anew, and
    the render equals a fresh render at those settings."""
    scene, cam, st = SCENES["earth"]()
    render(scene, cam, st)
    kw = {}
    if change == "bilinear_stochastic":
        kw = {"bilinear_stochastic": False}
    elif change == "sky_gradient":
        st = st._replace(sky_gradient=not st.sky_gradient)
    else:
        st = st._replace(**{change: getattr(st, change) + 2})
    img, counts = pack_counts(lambda: render(scene, cam, st, **kw))
    assert counts == [{"pack_misses": 1}]
    assert torch.equal(img, fresh(scene, cam, st, **kw))


@pytest.mark.parametrize("part", ["scene", "camera"])
def test_a_tensor_that_requires_grad_is_never_cached(part):
    """A scene or camera tensor that requires grad packs anew every call,
    and neither cache holds anything after."""
    scene, cam, st = SCENES["rand_spheres"]()
    if part == "scene":
        scene = dataclasses.replace(scene, mat_albedo=scene.mat_albedo.clone().requires_grad_())
    else:
        cam = dataclasses.replace(cam, look_from=cam.look_from.clone().requires_grad_())
    with torch.no_grad():
        assert chunk_renderer(scene, cam, st, CPU) is not chunk_renderer(scene, cam, st, CPU)
        assert not driver._RENDERER_CACHE and not driver._TABLE_CACHE
        (_, img), counts = pack_counts(lambda: (render(scene, cam, st), render(scene, cam, st)))
        assert torch.equal(img, render(scene, cam, st))
    assert counts == [{"pack_misses": 1}, {"pack_misses": 1}]
    assert not driver._RENDERER_CACHE and not driver._TABLE_CACHE


def test_explicit_clusters_bypass_the_cache():
    """A caller's own cluster table packs anew every call and is not
    cached."""
    scene, cam, st = SCENES["rand_spheres"]()
    scene_cl, cs = pbvh.cluster_scene(scene, max_leaf=8)
    first = chunk_renderer(scene_cl, cam, st, CPU, clusters=cs)
    second = chunk_renderer(scene_cl, cam, st, CPU, clusters=cs)
    assert second is not first and second.clusters.counts == first.clusters.counts
    assert not driver._RENDERER_CACHE and not driver._TABLE_CACHE


def test_a_clustered_hit_keeps_its_metrics():
    """A scene past CLUSTERED_SCENE_PRIMS: the second render's metrics name
    the builder and the cluster rows of the first and add no clustering
    seconds, and its image equals a fresh render's; a moved camera
    reorders the clusters, so its tables are packed anew."""
    scene, cam, st = builders.rand_spheres_large(width=8, spp=2, max_depth=3, n_spheres=2000)
    assert scene.num_prims > driver.CLUSTERED_SCENE_PRIMS

    def metered():
        m = RenderMetrics(total_spp=st.samples_per_pixel, pixels=st.width * st.height)
        return render(scene, cam, st, metrics=m), m

    (_, cold), ((img, warm), counts) = metered(), pack_counts(metered)
    assert counts == [{"pack_hits": 1}]
    assert cold.cluster_s > 0 and warm.cluster_s == 0
    assert warm.bvh_builder == cold.bvh_builder and warm.cluster_rows == cold.cluster_rows
    assert torch.equal(img, fresh(scene, cam, st))
    moved = dataclasses.replace(cam, look_from=cam.look_from + torch.tensor([3.0, 0.0, 0.0]))
    a, b = chunk_renderer(scene, cam, st, CPU), chunk_renderer(scene, moved, st, CPU)
    assert all(x is not y for x, y in zip(a.tables, b.tables))


def test_the_cache_holds_at_most_eight_entries():
    """Ten scenes packed in turn: each cache holds CACHE_ENTRIES (8) at
    most, the oldest dropped first, the newest kept."""
    assert driver.CACHE_ENTRIES == 8
    made = [SCENES["rand_spheres"]() for _ in range(10)]
    for scene, cam, st in made:
        chunk_renderer(scene, cam, st, CPU)
        assert len(driver._RENDERER_CACHE) <= 8 and len(driver._TABLE_CACHE) <= 8
    assert len(driver._RENDERER_CACHE) == len(driver._TABLE_CACHE) == 8
    _, counts = pack_counts(lambda: [render(*made[-1]), render(*made[0])])
    assert counts == [{"pack_hits": 1}, {"pack_misses": 1}]


@pytest.mark.parametrize("name", sorted(SCENES) + ["clustered"])
def test_cached_tables_keep_their_bytes_after_a_render(name):
    """Every tensor of a cached ChunkRenderer (tables, camera scalars,
    textures, cluster rows) holds the same bytes after a render from it."""
    if name == "clustered":
        scene, cam, st = builders.rand_spheres_large(width=8, spp=2, max_depth=3,
                                                     n_spheres=2000)
    else:
        scene, cam, st = SCENES[name]()
    renderer = chunk_renderer(scene, cam, st, CPU)
    before = [t.clone() for t in renderer_tensors(renderer)]
    render(scene, cam, st)
    assert chunk_renderer(scene, cam, st, CPU) is renderer
    after = renderer_tensors(renderer)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def copies_in(prof, span: str) -> int:
    """The host-to-device copies whose runtime call started inside `span`'s
    record_function range of the profile."""
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == span and e.device_type == DeviceType.CPU]
    return sum(1 for e in events if e.name in ("cudaMemcpyAsync", "cudaMemcpy")
               and any(a <= e.time_range.start < b for a, b in ranges))


@pytest.mark.cuda
def test_a_cached_pack_copies_and_syncs_nothing_on_the_card(cuda):
    """On the card the first render's `render/pack` makes the pack's
    synchronous copies; the second, from the cache, makes 0 syncs and 0
    host-to-device copies, and its image is bit-equal to a render with the
    cache emptied at the same seed."""
    scene, cam, st = get_scene("rand_spheres", width=64, spp=4, max_depth=8)
    # Builds the kernels, outside the profile, on a scene of its own.
    render_image(*get_scene("rand_spheres", width=8, spp=1, max_depth=2), device=cuda)
    packs = {}
    for which in ("miss", "hit"):
        trace.collect()
        trace.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                img = render_image(scene, cam, st, device=cuda, seed=11)
                torch.cuda.synchronize()
        finally:
            trace.disable()
        (span,) = [s for s in trace.collect() if s["name"] == "render/pack"]
        packs[which] = (span["syncs"], copies_in(prof, "render/pack"), span["counts"])
    assert packs["miss"][0] > 0 and packs["miss"][1] > 0
    assert packs["miss"][2] == {"pack_misses": 1}
    assert packs["hit"] == (0, 0, {"pack_hits": 1})
    clear_pack_cache()
    assert torch.equal(img, render_image(scene, cam, st, device=cuda, seed=11))
