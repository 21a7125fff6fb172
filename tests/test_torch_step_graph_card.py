"""The fit step's CUDA graph on the card (`harness/step_graph.py`).

`make_opt_train_step`'s step captures its loss and backward on its second
eligible call and replays the graph from then on.  In both fit
configurations of the benchmark (the robot lens, 450 patches, K1, at 512^2
rays; the refined robot, 1800 patches, K2, at 1024^2) six Adam steps of it
give winners, losses, gradients, parameters and kernel launches torch.equal
to an eager twin of its body on a copy of the lens; after a restart in
place, a hooked step runs eagerly and the replays after it are equal
again; `timing()` counts capture 1, replay 4, eager 1, and after the
restart eager 1, replay 2.  The graph exists only on the card: on the CPU
the step runs eagerly (tests/test_torch_lens_model.py).

Every test here is marked `cuda` and skips without a card.  This file
imports no JAX, so it runs on a machine with the card and no JAX:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_step_graph_card.py` from the repository root.
"""
import pytest
import torch

from cbtr_tpu_torch.harness import step_graph
from cbtr_tpu_torch.models import scenes

pytestmark = pytest.mark.cuda

CONFIGS = {"robot450": (512, False), "refined1800": (1024, True)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_replayed_steps_equal_the_eager_body(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    res, refine = CONFIGS[config]
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = scenes.robot_lens_scene(res=res, refine=refine, device="cuda")
    record = step_graph.compare(scene, steps=6, after_restart=2)
    assert record["paths"] == ["eager", "capture"] + ["replay"] * 4 + ["eager"] + \
        ["replay"] * 2, record
    assert record["counts"] == {"capture": 1, "replay": 4, "eager": 1}, record
    assert record["counts_after_restart"] == {"capture": 0, "replay": 2, "eager": 1}, record
    assert record["equal"], record
