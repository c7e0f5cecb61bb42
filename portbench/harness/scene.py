"""Seeded scenes, made on the device with one `torch.Generator` in a few
large calls and copied to the host once.

`inria_like` is a frozen form of the port's `make_inria_like_scene`, with
the statistics of a trained outdoor capture (Kerbl et al. 2023, the
Mip-NeRF 360 garden/bicycle class): 45% of the splats on a ground plane,
40% on the surfaces of six object blobs, 15% on a far background shell;
log-normal disc-like scales with a squashed minor axis; bimodal opacity (a
near-opaque mode and a translucent tail); natural albedos and SH energy
decaying by degree. Its Beta and Gamma draws are taken in closed forms
from uniforms (Kumaraswamy for the Betas, sums of exponentials for the
Gammas) so that the whole scene comes from the card's generator. The
splats are shuffled, as a trained capture's PLY order is.

The scene's layout (where the six blobs sit and how large they are) is
drawn from the configuration's `layout_seed`, the same for every run; the
run's seed draws every splat. So every seed renders the same kind of scene
at the same cost, with other splats."""

from __future__ import annotations

import numpy as np
import torch

SH_C0 = 0.28209479177387814
FIELDS = ("pos", "normal", "sh0", "sh_rest", "opacity", "scale", "rot")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def inria_like(n: int, scene_scale: float, gen: torch.Generator, device,
               layout: torch.Generator) -> dict:
    """(N,)-leading f32 arrays of one scene, on `device`; the blobs' layout
    from `layout`, every splat from `gen`."""
    f32, s = torch.float32, float(scene_scale)

    def uni(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=f32)

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=f32)

    def unit(k):
        v = nrm(k, 3)
        return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-9)

    def gamma2(*shape):  # Gamma(2, 1): a sum of two exponentials
        return -(torch.log1p(-uni(*shape)) + torch.log1p(-uni(*shape)))

    def kumaraswamy(a, b, k):  # Beta-like on (0, 1)
        return (1.0 - (1.0 - uni(k)) ** (1.0 / b)) ** (1.0 / a)

    n_ground, n_obj = int(n * 0.45), int(n * 0.40)
    n_bg = n - n_ground - n_obj
    ground = torch.stack([(uni(n_ground) * 2 - 1) * s, -0.6 * s + 0.02 * s * nrm(n_ground),
                          (uni(n_ground) * 2 - 1) * s], dim=1)
    lay = torch.rand((6, 5), generator=layout, device=device, dtype=f32)
    centers = (lay[:, :3] - 0.5) * s
    centers[:, 1] = -0.5 * s + lay[:, 3] * 0.6 * s
    radii = (0.08 + 0.17 * lay[:, 4]) * s
    which = torch.randint(0, 6, (n_obj,), generator=gen, device=device)
    objs = centers[which] + unit(n_obj) * radii[which][:, None] * uni(n_obj, 1) ** 0.25
    bg = unit(n_bg) * (2.0 + uni(n_bg, 1)) * s
    pos = torch.cat([ground, objs, bg])

    scale = np.log(0.008 * s) + 0.7 * nrm(n, 1) + 0.35 * nrm(n, 3)
    minor = torch.randint(0, 3, (n,), generator=gen, device=device)
    scale[torch.arange(n, device=device), minor] -= 0.6 * gamma2(n)
    scale = scale.clamp(np.log(1e-4 * s), np.log(0.1 * s))

    take_hi = uni(n) < 0.62
    op = torch.where(take_hi, kumaraswamy(8.0, 1.3, n), kumaraswamy(1.5, 6.0, n))
    op = op.clamp(0.02, 0.995)
    opacity = torch.log(op) - torch.log1p(-op)

    d = gamma2(n, 3)
    albedo = (0.25 + 0.75 * d / d.sum(dim=1, keepdim=True) + 0.08 * nrm(n, 3)).clamp(0.02, 0.98)
    sh0 = (albedo - 0.5) / SH_C0
    std = torch.tensor([0.16] * 3 + [0.07] * 5 + [0.03] * 7, device=device)
    sh_rest = nrm(n, 15, 3) * std[None, :, None]

    rot = nrm(n, 4)
    rot = rot / rot.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rot[:, 0] = rot[:, 0].abs()
    perm = torch.randperm(n, generator=gen, device=device)
    out = {"pos": pos[perm], "normal": torch.zeros((n, 3), device=device, dtype=f32),
           "sh0": sh0[perm], "sh_rest": sh_rest[perm], "opacity": opacity[perm],
           "scale": scale[perm], "rot": rot[perm]}
    return {k: v.contiguous() for k, v in out.items()}


MAKERS = {"inria_like": inria_like}


def make_models(config: dict, seed: int, device) -> list:
    """Each model of the configuration's scene as host numpy arrays (the
    fields of a Gaussians record), drawn in order from one generator."""
    gen = generator(seed, device)
    models = []
    for k, m in enumerate(config["scene"]["models"]):
        layout = generator(int(config["scene"]["layout_seed"]) + k, device)
        arrays = MAKERS[config["scene"]["generator"]](int(m["splats"]), float(m["scene_scale"]),
                                                      gen, device, layout)
        models.append({k: arrays[k].cpu().numpy() for k in FIELDS})
        del arrays
    return models
