"""Rendering: ray generation, lens imaging, differentiable splatting."""
from .camera import ortho_ray_grid  # noqa: F401
from .render import render_lens_image, screen_hits, splat_bilinear  # noqa: F401
