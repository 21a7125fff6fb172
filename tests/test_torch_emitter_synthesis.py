"""The port's ray synthesis layer, `render/emitters.py::synthesize`, on the
CPU.

Its rays are torch.equal to the body `DeviceEmitter.rays_at` had before the
layer was split out (frozen below), and to that float tail fed with the JAX
package's draws (`u`, `patch`, `j`, `cnt`): so the layer draws what
jax.random draws.  Every emitter caller of the port calls it through the
module's attribute, so wrapping the attribute wraps them all.  Under
`profiling.timing()` it records `cbtr.emitter` once a render; its device
time (`cbtr.emitter.device`) is recorded only where its work is on a card,
so a CPU run has none.  The event pairs' arithmetic runs on stand-in events.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.render import emitters as jax_em

from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.parallel import multihost
from cbtr_tpu_torch.render import emitters, render
from cbtr_tpu_torch.utils import profiling

torch.set_num_threads(2)

EMITTER_ORIGIN = tuple(
    (np.asarray(scenes.LENS_CENTER) - np.array([3.0, 0, 0], np.float32)).tolist()
)
CASES = [(8, 16384, 3), (16, 262144, 1), (5, 4096, 2**31 + 5)]


def _tail(em, t, u, patch, j, cnt):
    """The float part of the former `DeviceEmitter.rays_at`, as it was."""
    cos_a, cos_b = t["cos_a"][patch], t["cos_b"][patch]
    u1 = (j + u[:, 0]) / cnt
    cosv = cos_a - u1 * (cos_a - cos_b)
    sinv = torch.sqrt(torch.clamp(1.0 - cosv * cosv, min=0.0))
    turn = t["turn0"][patch] + u[:, 1] * t["turn_w"][patch]
    d = torch.stack([cosv, sinv * torch.cos(turn), sinv * torch.sin(turn)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    start = torch.as_tensor(em.origin, dtype=torch.float32, device=patch.device)
    weight = t["frac"][patch] * float(em.n_rays) / cnt
    return start.expand(d.shape).contiguous(), d, weight


def _former_rays_at(em, idx):
    t = em._device_tables(idx.device)
    return _tail(em, t, *em.bins_at(idx, t))


def _jax_draws(em, idx):
    """The JAX DeviceEmitter.rays_at's integer and random part
    (cbtr_tpu/render/emitters.py:132-142), as torch tensors."""
    t = {k: jnp.asarray(v) for k, v in em._tables().items()}
    key = jax.random.PRNGKey(em.seed)
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key, i), (2,)))(idx)
    patch = jnp.minimum(jnp.searchsorted(t["bounds"], idx, side="right"),
                        t["bounds"].shape[0] - 1)
    cnt = jnp.maximum(t["nb"][patch], 1).astype(jnp.float32)
    j = (idx - t["starts"][patch]).astype(jnp.float32)
    return [torch.as_tensor(np.array(x)) for x in (u, patch, j, cnt)]


@pytest.mark.parametrize("belts,n,seed", CASES)
def test_synthesize_equals_the_former_rays_at(belts, n, seed):
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, belts, n, seed)
    idx = torch.arange(n)
    got = emitters.synthesize(em, idx)
    for a, b in zip(got, _former_rays_at(em, idx)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for a, b in zip(em.rays_at(idx), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("belts,n,seed", CASES)
def test_synthesize_draws_what_jax_draws(belts, n, seed):
    """At 4096 indices spread over the set: the rays are the former float
    tail of the JAX package's draws, torch.equal."""
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, belts, n, seed)
    em_j = jax_em.DeviceEmitter(EMITTER_ORIGIN, belts, n, seed)
    idx = np.unique(np.linspace(0, n - 1, 4096).astype(np.int32))
    t = em._device_tables(torch.device("cpu"))
    want = _tail(em, t, *_jax_draws(em_j, jnp.asarray(idx)))
    for a, b in zip(emitters.synthesize(em, torch.as_tensor(idx, dtype=torch.int64)), want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def sphere():
    return scenes.sphere_lens_scene(res=4, sectors=9, belts=4, device="cpu")


def _three_callers(scene, em):
    """One call of each emitter caller of the port: the device render, the
    multihost render, the multihost SGD step."""
    render.render_emitter_image_device(scene.patches, scene.refractive_index, em,
                                       scene.screen_plane, resolution=16)
    with torch.no_grad():
        img = multihost.render_multihost_emitter(None, scene.patches, scene.refractive_index,
                                                 em, scene.screen_plane, resolution=16)
    step = multihost.make_multihost_train_step_emitter(None, scene.screen_plane, img,
                                                       em, resolution=16)
    step(lens_model.params_from_scene(scene))       # its own copy of the lens


def test_wrapping_the_attribute_wraps_every_caller(sphere, monkeypatch):
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, 4, 512, 3)
    seen, synthesize = [], emitters.synthesize

    def wrapped(emitter, idx):
        seen.append((emitter, idx.shape[0]))
        return synthesize(emitter, idx)

    monkeypatch.setattr(emitters, "synthesize", wrapped)
    _three_callers(sphere, em)
    assert seen == [(em, 512)] * 3


def test_timing_records_the_synthesis_once_a_render_and_no_device_time_on_the_cpu(sphere):
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, 4, 512, 3)
    with profiling.timing() as times:
        for _ in range(2):
            with torch.no_grad():
                multihost.render_multihost_emitter(None, sphere.patches,
                                                   sphere.refractive_index, em,
                                                   sphere.screen_plane, resolution=16)
    assert times["cbtr.emitter"][1] == 2 and times["cbtr.render"][1] == 2
    assert not any(name.endswith(".device") for name in times) and not times.pending


def test_a_device_timed_span_off_is_its_names_shared_no_op():
    a = profiling.span("cbtr.emitter", device=True)
    assert a is profiling.span("cbtr.emitter", device=True)
    assert a is not profiling.span("cbtr.emitter")


class _Event:
    """A stand-in for a CUDA timing event at a fixed time (ms)."""

    def __init__(self, ms):
        self.ms, self.waited = ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_resolve_adds_each_event_pairs_device_time():
    times = profiling.SpanTimes()
    ends = [_Event(3.5), _Event(0.25)]
    times.add_events("cbtr.emitter", _Event(1.0), ends[0])
    times.add_events("cbtr.emitter", _Event(0.0), ends[1])
    assert "cbtr.emitter.device" not in times
    times.resolve()
    assert times["cbtr.emitter.device"] == [2_750_000, 2]
    assert all(e.waited for e in ends) and not times.pending
