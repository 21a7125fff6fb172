"""The inputs a cell hands to the program and to the reference alike, made
from the seed: the collimated beam (with its seeded sub-pixel offset) and the
fit's target image.  The same seed gives the same inputs."""
from __future__ import annotations

import numpy as np
import torch


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def beam(traffic: dict, seed: int) -> dict:
    """The beam of `traffic`: res x res rays on a width x width square in
    the plane x = 0 heading +x (the port's `scene_ortho_grid` frame), its
    centre moved by a seeded offset of up to `offset_pixels` of a ray pitch
    along each axis of the square."""
    width = float(traffic["beam_width"])
    res = int(traffic["res"])
    frac = float(traffic.get("offset_pixels", 0.0))
    oy, oz = (rng(seed).uniform(-frac, frac, 2) * width / res) if frac else (0.0, 0.0)
    return {"center": (0.0, float(oy), float(oz)), "direction": (1.0, 0.0, 0.0),
            "up": (0.0, 0.0, 1.0), "width": width, "res": res}


def screen_plane(traffic: dict, device) -> torch.Tensor:
    """The screen: the plane x = screen_x, its normal +x."""
    return torch.tensor([1.0, 0.0, 0.0, float(traffic["screen_x"])], dtype=torch.float32,
                        device=device)


def target(traffic: dict, seed: int, n_rays: int, device) -> torch.Tensor:
    """[res, res] float32 target: `blobs` Gaussian spots with seeded centres
    (uniform within `spread` of the screen's centre) and widths (uniform in
    `sigma`), on the image's pixel centres over [-extent, extent]^2, scaled
    to a total of `flux` x n_rays."""
    t = traffic["target"]
    g = rng(seed + 1)
    res, extent = int(traffic["image_res"]), float(traffic["extent"])
    k = int(t["blobs"])
    centres = g.uniform(-t["spread"], t["spread"], (k, 2))
    sigmas = g.uniform(t["sigma"][0], t["sigma"][1], k)
    x = ((np.arange(res) + 0.5) / res - 0.5) * 2.0 * extent
    xx, yy = np.meshgrid(x, x, indexing="ij")
    img = sum(np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / (2.0 * s * s))
              for c, s in zip(centres, sigmas))
    img = img / img.sum() * float(t["flux"]) * n_rays
    return torch.as_tensor(img, dtype=torch.float32, device=device)
