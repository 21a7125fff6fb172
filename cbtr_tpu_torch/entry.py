"""Entry points of the port: the counterpart of __graft_entry__.py.

`entry(device="cuda")` -> (fn, example_args): the forward of the flagship
model (robot.stl Bezier lens -> refraction -> screen irradiance image) at
32^2 rays and a 32^2 image; fn(*example_args) is the image.

`dryrun_multichip(n, device="cuda")`: one SGD step of the full train step
on a 2-D ('rays', 'patches') mesh of the n ranks of the running process
group, on tiny shapes: the rays split over the first dimension, the
intersection's patch sweep over the second (K3 on the card), injected
into the Snell physics through `refract_rays(intersect_fn=)`.
"""
from __future__ import annotations

import torch


def entry(device="cuda"):
    """Forward step of the robot lens and its example arguments
    (control points, refractive index, start, direction) on `device`."""
    from .models import robot_lens_scene
    from .render.render import render_lens_image

    scene = robot_lens_scene(res=32, device=device)

    def forward(control_points, refractive_index, start, direction):
        return render_lens_image(scene.patches.replace(control_points=control_points),
                                 refractive_index, start, direction, scene.screen_plane,
                                 resolution=32, extent=4.0)

    example_args = (scene.patches.control_points,
                    torch.tensor(scene.refractive_index, dtype=torch.float32, device=device),
                    scene.start, scene.direction)
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """One SGD step of the ('rays', 'patches') train step over the n_devices
    ranks of the running process group (no group: n_devices must be 1, a
    world of one).  The mesh is (n/2, 2) for even n, else (n, 1); each ray
    rank traces 8 rays of the sphere 5 x 2 at a 8^2 image.  Returns the
    loss; a non-finite one raises FloatingPointError."""
    import torch.distributed as dist

    from .models import sphere_lens_scene
    from .models.lens_model import params_from_scene
    from .parallel.sharding import make_sharded_train_step, mesh_device_type

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a process group of "
                         f"{n_devices} ranks, found {world}")
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(mesh_device_type(), shape,
                                mesh_dim_names=("rays", "patches"))
    scene = sphere_lens_scene(res=8, sectors=5, belts=2, device=device)
    n_rays = 8 * shape[0]      # divisible by the ray dimension
    step = make_sharded_train_step(mesh, scene.screen_plane,
                                   torch.zeros((8, 8), dtype=torch.float32, device=device),
                                   resolution=8, learning_rate=1e-4, patch_axis="patches")
    _, loss = step(params_from_scene(scene), scene.start[:n_rays], scene.direction[:n_rays])
    if not torch.isfinite(loss):
        raise FloatingPointError("the multichip dry run gave a non-finite loss")
    return float(loss)
