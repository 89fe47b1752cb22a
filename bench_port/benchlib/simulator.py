"""Disk-tracking frames, made on the card: a frozen copy of the port's
``nfdpf_torch/data/simulator.py`` (draws, dynamics and painter), so that a
change to the program cannot change the traffic.

A red disk (radius 7) and coloured distractors (radius 3-9) move on a
128x128 canvas; pos' = pos + vel + N(0, pos_noise²), vel' = vel − 0.1·pos −
0.0075·vel²·sign(vel); frames are uint8 HWC.
"""

from __future__ import annotations

from typing import Dict

import torch

SPRING_FORCE = 0.1
DRAG_FORCE = 0.0075
RED_RADIUS = 7.0
RED = (255.0, 0.0, 0.0)
DISTRACTOR_COLORS = (
    (0.0, 255.0, 0.0),
    (0.0, 0.0, 255.0),
    (0.0, 255.0, 255.0),
    (255.0, 0.0, 255.0),
    (255.0, 255.0, 0.0),
    (255.0, 255.0, 255.0),
)


def process_model(state: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One Euler step of the spring and drag dynamics; state (..., 4)."""
    pos, vel = state[..., :2], state[..., 2:]
    pull = -SPRING_FORCE * pos
    drag = -DRAG_FORCE * vel**2 * torch.sign(vel)
    return torch.cat([pos + vel + noise, vel + pull + drag], dim=-1)


def render_frames(centers: torch.Tensor, radii: torch.Tensor, colors: torch.Tensor,
                  im_size: int) -> torch.Tensor:
    """Paint (F, D) disks in z-order at integer ``centers`` (F, D, 2):
    uint8 frames (F, H, W, 3)."""
    frames, disks = centers.shape[:2]
    ax = torch.arange(im_size, dtype=torch.float32, device=centers.device)
    canvas = torch.zeros((frames, im_size, im_size, 3), device=centers.device)
    for d in range(disks):
        cols = (ax[None, :] - centers[:, d, 0:1]) ** 2
        rows = (ax[None, :] - centers[:, d, 1:2]) ** 2
        dist2 = cols[:, None, :] + rows[:, :, None]
        mask = (dist2 <= (radii[:, d] ** 2)[:, None, None])[..., None]
        canvas = torch.where(mask, colors[:, d, None, None, :], canvas)
    return canvas.to(torch.uint8)


def sequences(generator: torch.Generator, num: int, seq_len: int, num_distractors: int,
              pos_noise: float, im_size: int) -> Dict[str, torch.Tensor]:
    """``num`` sequences on the generator's device: ``image`` (S, T, H, W, 3)
    uint8, ``state`` (S, T, 4) and ``start_state`` (S, 4)."""
    dev = generator.device
    half = im_size // 2
    nd = num_distractors

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev) * (2 * half) - half

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    red = torch.cat([uniform((num, 2)), normal((num, 2), 3.0)], dim=-1)
    dist = torch.cat([uniform((num, nd, 2)), normal((num, nd, 2), 3.0)], dim=-1)
    radii = torch.randint(3, 10, (num, nd), generator=generator, device=dev).to(torch.float32)
    color_index = torch.randint(0, len(DISTRACTOR_COLORS), (num, nd), generator=generator,
                                device=dev)
    noise = normal((num, seq_len, 1 + nd, 2), pos_noise)
    colors = torch.tensor(DISTRACTOR_COLORS, device=dev)[color_index]

    reds, dists = [red], [dist]
    for step in range(seq_len):
        reds.append(process_model(reds[-1], noise[:, step, 0]))
        dists.append(process_model(dists[-1], noise[:, step, 1:]))
    red_all = torch.stack(reds, dim=1)                          # (S, T+1, 4)
    dist_all = torch.stack(dists, dim=1)                        # (S, T+1, K, 4)
    centers = torch.cat([red_all[..., None, :2], dist_all[..., :2]], dim=-2)[:, 1:]
    centers = torch.trunc(centers + half).reshape(num * seq_len, 1 + nd, 2)
    all_radii = torch.cat([torch.full((num, 1), RED_RADIUS, device=dev), radii], dim=-1)
    all_colors = torch.cat([torch.tensor(RED, device=dev).expand(num, 1, 3), colors], dim=-2)
    frames = render_frames(
        centers, all_radii[:, None].expand(num, seq_len, 1 + nd).reshape(-1, 1 + nd),
        all_colors[:, None].expand(num, seq_len, 1 + nd, 3).reshape(-1, 1 + nd, 3), im_size)
    return {"image": frames.reshape(num, seq_len, im_size, im_size, 3),
            "state": red_all[:, 1:], "start_state": red}
