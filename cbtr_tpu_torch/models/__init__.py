"""Ready-made lens scenes, the differentiable lens model and the fit loop."""
from .scenes import (  # noqa: F401
    LensScene,
    dimpled_lens_scene,
    ellipsoid_lens_scene,
    robot_lens_scene,
    scene_ortho_grid,
    sphere_lens_scene,
)
from .lens_model import (  # noqa: F401
    LensParams,
    lens_forward,
    lens_loss,
    make_opt_train_step,
    make_train_step,
    params_from_scene,
)
from .fit import emitter_rays, fit_emitter_lens, fit_lens  # noqa: F401
