"""Rendering: ray generation, lens imaging, differentiable splatting."""
from .camera import (  # noqa: F401
    OrthoGrid,
    angle_sweep_rays,
    ortho_ray_grid,
    pinhole_ray_grid,
)
from .emitters import DeviceEmitter, UniformHemisphere, sample_hemisphere  # noqa: F401
from .render import (  # noqa: F401
    render_emitter_image,
    render_emitter_image_device,
    render_lens_image,
    render_surface_normals,
    screen_hits,
    splat_bilinear,
)
