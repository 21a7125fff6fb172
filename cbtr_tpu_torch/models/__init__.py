"""Ready-made lens scenes and the differentiable lens model."""
from .scenes import (  # noqa: F401
    LensScene,
    dimpled_lens_scene,
    ellipsoid_lens_scene,
    robot_lens_scene,
    sphere_lens_scene,
)
from .lens_model import (  # noqa: F401
    LensParams,
    lens_forward,
    lens_loss,
    make_train_step,
    params_from_scene,
)
