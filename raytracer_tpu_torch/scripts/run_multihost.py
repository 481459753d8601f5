"""Multi-node render launcher (port of scripts/run_multihost.py).

On a cluster, start this script once per GPU with `torchrun` on every node;
the process group comes from torchrun's environment (NCCL, one rank a GPU),
the mesh lays image tiles across nodes and the sample budget across each
node's GPUs (parallel/mesh.py:multihost_mesh), and rank 0 writes the image.

    torchrun --nnodes 2 --nproc-per-node 8 --rdzv-endpoint HOST:PORT \\
        -m raytracer_tpu_torch.scripts.run_multihost --scene rand_spheres --spp 500

Local testing without a cluster: --coordinator host:port, --num-processes
and --process-id start one gloo rank on the CPU per process, the same group
and mesh code path with gloo over localhost in place of the interconnect.
One process is one rank, so the JAX script's --local-devices has no
counterpart; the image depends only on the seed and the mesh shape.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rand_spheres")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out/multihost.png")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0, for local multi-process testing on the CPU")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--sample-parallel", type=int, default=None,
                    help="ranks cooperating on the same pixels (the mesh's samples axis; "
                    "default the ranks per node)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from raytracer_tpu_torch.imgio.image import write_png
    from raytracer_tpu_torch.parallel.mesh import close_group, init_group, multihost_mesh
    from raytracer_tpu_torch.parallel.shard import render_image_sharded
    from raytracer_tpu_torch.render.postprocess import to_u8
    from raytracer_tpu_torch.scenes.registry import get_scene

    if args.coordinator is not None:
        dev = init_group("cpu", coordinator=args.coordinator, process_id=args.process_id,
                         num_processes=args.num_processes)
    else:
        dev = init_group("cuda")
    try:
        overrides = {}
        if args.spp:
            overrides["spp"] = args.spp
        if args.width:
            overrides["width"] = args.width
        scene, cam, settings = get_scene(args.scene, args.seed, **overrides)
        mesh = multihost_mesh(args.sample_parallel, device=dev)
        root = dist.get_rank() == 0
        if root:
            print(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} over {mesh.size} ranks "
                  f"({mesh.backend})", flush=True)
        t0 = time.perf_counter()
        img = to_u8(render_image_sharded(scene, cam, settings, mesh, seed=args.seed)).cpu()
        dt = time.perf_counter() - t0
        if root:
            write_png(args.out, img.numpy())
            rays = settings.width * settings.height * settings.samples_per_pixel
            print(f"done in {dt:.2f}s, {rays / dt / 1e6:.1f} camera Mrays/s aggregate -> "
                  f"{args.out}", flush=True)
    finally:
        close_group()


if __name__ == "__main__":
    main()
