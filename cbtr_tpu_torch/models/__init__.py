"""Ready-made lens scenes and the differentiable lens model."""
from .scenes import LensScene, robot_lens_scene, sphere_lens_scene  # noqa: F401
from .lens_model import (  # noqa: F401
    LensParams,
    lens_forward,
    lens_loss,
    make_train_step,
    params_from_scene,
)
