"""The numbers `correct` is decided on: the program's outputs against the
plain reference's.  Each is 0 where the two agree, and grows with the
disagreement; the cell's limits file gives each its limit."""
from __future__ import annotations

import torch

# the leaves of a patch build the program's tables are compared on
BUILD_LEAVES = ("control_points", "underlying", "dividers", "bary_inverse", "heights",
                "deriv_b")


def build_gap(program, reference) -> float:
    """The largest, over the float leaves of the patch tables, of the leaf's
    median absolute gap over its median absolute value in the reference;
    1 where the patch counts or the neighbour tables differ.  Medians, since
    the float32 build amplifies rounding on a few ill-conditioned patches
    (the three-plane intersections), where a largest gap reads that alone."""
    if (program.control_points.shape != reference.control_points.shape
            or not torch.equal(program.neighbours.long().cpu(), reference.neighbours.long().cpu())):
        return 1.0
    gaps = []
    for name in BUILD_LEAVES:
        a = getattr(program, name).double()
        b = getattr(reference, name).to(a.device, torch.float64)
        gaps.append(float((a - b).abs().median() / b.abs().median().clamp_min(1e-300)))
    return max(gaps)


def pass_gap(program: dict, reference: dict) -> float:
    """The share of rays whose pass disagrees with the reference's: another
    winning patch (or a hit against a miss) or another refraction status
    (refracted, missed, totally reflected, or not the transition expected).
    Each dict: patch [R] (-1 a miss), status [R]; 1 where the program's
    pass holds another number of rays."""
    dev = reference["patch"].device
    if program["patch"].shape != reference["patch"].shape:
        return 1.0
    off = program["patch"].to(dev).long() != reference["patch"].long()
    off |= program["status"].to(dev).long() != reference["status"].long()
    return float(off.double().mean())


def image_gap(program, reference) -> float:
    """The sum of the pixels' absolute gaps over the reference image's sum:
    where each ray lands, through its hit points and refracted directions."""
    a = program.to(reference.device, torch.float64)
    return float((a - reference).abs().sum() / reference.abs().sum().clamp_min(1e-300))


def rerun_gap(a, b) -> float:
    """The largest gap between two images of the program, over the first's
    largest pixel (0 when the two are equal bit for bit)."""
    return float((a.double() - b.double()).abs().max() / a.double().abs().max().clamp_min(1e-300))


def leaf_norms(control_points, refractive_index) -> torch.Tensor:
    """The norm of each of the fit's leaves, float64 on the CPU: each
    patch's control points [10, 3] (the tensor holds the patches side by
    side), then the refractive index."""
    cp = control_points.detach().double()
    return torch.cat([torch.linalg.vector_norm(cp.reshape(cp.shape[0], -1), dim=1),
                      refractive_index.detach().double().abs().reshape(1)]).cpu()


def leaf_gap(program, reference, reference_grad, q: float = 1.0) -> float:
    """The q-quantile (1.0: the worst leaf), over the leaves, of the gap
    between the program's norm of a leaf and the reference's, over the larger
    of that reference norm and the median leaf's (the median of the
    reference's nonzero leaf norms).  Each argument is `leaf_norms`'.
    Leaves are left out by the reference's step-1 gradient: those under a
    thousandth of the median leaf's gradient norm, which no ray reaches in
    the reference or round-off alone moves (under Adam such a leaf steps by
    the learning rate all the same)."""
    ref, got, grad = reference, program, reference_grad
    if not (ref > 0.0).any() or not (grad > 0.0).any():
        return float("inf")
    kept = grad >= float(grad[grad > 0.0].median()) / 1000.0
    median = float(ref[ref > 0.0].median())
    gaps = (got[kept] - ref[kept]).abs() / ref[kept].clamp_min(median)
    return float(torch.quantile(gaps, q))


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)
