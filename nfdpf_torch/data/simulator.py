"""Disk-tracking simulator: a red disk and coloured distractors on a 128²
canvas.

Counterpart of ``nfdpf_tpu/data/simulator.py``, with the same dynamics,
observation semantics and npz layout.  The random draws are split from the
deterministic part: ``DiskSimulator.draw_sequence`` makes every draw of a
batch of sequences from a ``torch.Generator``, and
``DiskSimulator.sequence_from_draws`` turns them into records, so a test can
feed it draws replayed from the JAX key schedule.  Both run on the
generator's device, vectorised over sequences and time; the painter loops
over the disks in z-order only.

Dynamics:
    pos'  = pos + vel + N(0, pos_noise²)
    vel'  = vel − 0.1·pos − 0.0075·vel²·sign(vel)
(q = [σp, σp, 2, 2]).

Observation: the red disk (radius 7) first, then the distractors (radius
in {3..9}, one of 6 colours) over it, at centres truncated as
``trunc(c + half)``; a pixel is painted where ``dist² <= r²``; visibility is
the count of exactly-red pixels; frames are uint8 HWC (RGB).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

SPRING_FORCE = 0.1
DRAG_FORCE = 0.0075
RED_RADIUS = 7.0
RED = (255.0, 0.0, 0.0)
# the distractor palette, RGB values as the JAX package stores them
DISTRACTOR_COLORS = (
    (0.0, 255.0, 0.0),
    (0.0, 0.0, 255.0),
    (0.0, 255.0, 255.0),
    (255.0, 0.0, 255.0),
    (255.0, 255.0, 0.0),
    (255.0, 255.0, 255.0),
)

log = logging.getLogger("nfdpf.simulator")


def process_model(state: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One Euler step of the spring+drag dynamics, in the JAX package's
    operation order (a reordering moves the last bit, and over 50 steps a
    truncated centre).

    state: (..., 4) = [x, y, vx, vy]; noise: (..., 2) position noise.
    """
    pos, vel = state[..., :2], state[..., 2:]
    pull = -SPRING_FORCE * pos
    drag = -DRAG_FORCE * vel**2 * torch.sign(vel)
    new_pos = pos + vel + noise
    new_vel = vel + pull + drag
    return torch.cat([new_pos, new_vel], dim=-1)


def render_frame(
    state: torch.Tensor,              # (..., 4) red-disk state
    distractor_states: torch.Tensor,  # (..., K, 4)
    distractor_radii: torch.Tensor,   # (..., K)
    distractor_colors: torch.Tensor,  # (..., K, 3)
    im_size: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rasterise frames, any leading shape, painting the disks in z-order
    (red first).  Returns (images (..., H, W, 3) uint8, visible red-pixel
    counts (...,) int32).  The centres are integers and the radii small
    integers, so every distance is exact in float32."""
    lead = state.shape[:-1]
    dev = state.device
    half = im_size // 2
    centers = torch.cat([state[..., None, :2], distractor_states[..., :2]], dim=-2)
    centers = torch.trunc(centers + half).reshape(-1, centers.shape[-2], 2)
    frames, disks = centers.shape[:2]
    red_radius = torch.full(lead + (1,), RED_RADIUS, device=dev)
    radii = torch.cat([red_radius, distractor_radii.to(torch.float32)], dim=-1)
    radii = radii.reshape(frames, disks)
    red = torch.tensor(RED, device=dev).expand(lead + (1, 3))
    colors = torch.cat([red, distractor_colors.to(torch.float32)], dim=-2)
    colors = colors.reshape(frames, disks, 3)

    ax = torch.arange(im_size, dtype=torch.float32, device=dev)
    canvas = torch.zeros((frames, im_size, im_size, 3), device=dev)
    for d in range(disks):
        cols = (ax[None, :] - centers[:, d, 0:1]) ** 2     # (F, W): cx is the column
        rows = (ax[None, :] - centers[:, d, 1:2]) ** 2     # (F, H): cy the row
        dist2 = cols[:, None, :] + rows[:, :, None]
        mask = (dist2 <= (radii[:, d] ** 2)[:, None, None])[..., None]
        canvas = torch.where(mask, colors[:, d, None, None, :], canvas)

    red_mask = (canvas[..., 0] == 255.0) & (canvas[..., 1] == 0.0) & (canvas[..., 2] == 0.0)
    vis = red_mask.sum(dim=(1, 2), dtype=torch.int32)
    images = canvas.to(torch.uint8).reshape(lead + (im_size, im_size, 3))
    return images, vis.reshape(lead)


@dataclass(frozen=True)
class DiskSimulator:
    """Sequence generator (the reference's ``ToyExample``)."""

    im_size: int = 128
    sequence_length: int = 50
    num_distractors: int = 25
    pos_noise: float = 2.0

    def draw_sequence(self, generator: torch.Generator, num: int = 1) -> Dict[str, torch.Tensor]:
        """Every random draw of ``num`` sequences, on the generator's device:
        initial positions U(−half, half) and velocities N(0, 3²) of the red
        disk (``pos0``, ``vel0``: (num, 2)) and of the distractors
        (``d_pos0``, ``d_vel0``: (num, K, 2)), the distractors' radii in
        {3..9} and colour indices in {0..5} ((num, K) int64), and the
        position noise N(0, pos_noise²) of every step, red disk first
        (``noise``: (num, T, 1+K, 2))."""
        dev = generator.device
        half = self.im_size // 2
        nd, t = self.num_distractors, self.sequence_length

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=dev) * (2 * half) - half

        def normal(shape, std):
            return torch.randn(shape, generator=generator, device=dev) * std

        return {
            "pos0": uniform((num, 2)),
            "vel0": normal((num, 2), 3.0),
            "d_pos0": uniform((num, nd, 2)),
            "d_vel0": normal((num, nd, 2), 3.0),
            "radii": torch.randint(3, 10, (num, nd), generator=generator, device=dev),
            "color_index": torch.randint(0, len(DISTRACTOR_COLORS), (num, nd),
                                         generator=generator, device=dev),
            "noise": normal((num, t, 1 + nd, 2), self.pos_noise),
        }

    def sequence_from_draws(self, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The records (start_image, start_state, image, state, q, visible)
        of a batch of sequences, from ``draw_sequence``'s draws (any
        device; the result stays there)."""
        red0 = torch.cat([draws["pos0"], draws["vel0"]], dim=-1)           # (S, 4)
        d_state0 = torch.cat([draws["d_pos0"], draws["d_vel0"]], dim=-1)   # (S, K, 4)
        num, t = red0.shape[0], self.sequence_length
        palette = torch.tensor(DISTRACTOR_COLORS, device=red0.device)
        colors = palette[draws["color_index"]]                             # (S, K, 3)
        radii = draws["radii"].to(torch.float32)

        reds, dists = [red0], [d_state0]
        for step in range(t):
            reds.append(process_model(reds[-1], draws["noise"][:, step, 0]))
            dists.append(process_model(dists[-1], draws["noise"][:, step, 1:]))
        red_all = torch.stack(reds, dim=1)                                 # (S, T+1, 4)
        dist_all = torch.stack(dists, dim=1)                               # (S, T+1, K, 4)
        frames = (num, t + 1)
        images, vis = render_frame(
            red_all, dist_all, radii[:, None].expand(frames + radii.shape[1:]),
            colors[:, None].expand(frames + colors.shape[1:]), self.im_size)
        q = torch.tensor([self.pos_noise, self.pos_noise, 2.0, 2.0], device=red0.device)
        return {
            "start_image": images[:, 0],
            "start_state": red0,
            "image": images[:, 1:],
            "state": red_all[:, 1:],
            "q": q.expand(num, t, 4),
            "visible": vis[:, 1:],
        }

    def generate_batch(self, generator: torch.Generator, num: int,
                       chunk: int = 32) -> Dict[str, np.ndarray]:
        """``num`` sequences as host arrays, made on the generator's device
        ``chunk`` sequences at a time (the frames of one chunk at full size
        are 80 MB of uint8, their float canvas 4× that)."""
        outs = []
        t0 = time.time()
        for lo in range(0, num, chunk):
            rec = self.sequence_from_draws(self.draw_sequence(generator, min(chunk, num - lo)))
            outs.append({k: v.cpu().numpy() for k, v in rec.items()})
            log.info("generated %d/%d sequences [%.0fs]", lo + len(outs[-1]["state"]), num,
                     time.time() - t0)
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


def generate_dataset(
    out_dir: str,
    num_examples: int = 1000,
    file_size: int = 500,
    num_distractors: int = 25,
    pos_noise: float = 2.0,
    sequence_length: int = 50,
    im_size: int = 128,
    seed: int = 0,
    name: str = "toy",
    device=None,
) -> None:
    """Generate and save npz shards with the reference's naming and layout:
    an 80/10/10 split per shard, files
    ``<name>_pn=<σ>_d=<K>_const<i>_{train,val,test}.npz`` each holding one
    dict of arrays under the ``{split}_data`` key; shard ``i`` is permuted by
    ``np.random.default_rng(seed + i)``.  Runs on ``cuda`` and raises without
    a GPU unless given ``device="cpu"``."""
    from nfdpf_torch.models.dpf import resolve_device

    generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)
    full_name = f"{name}_pn={pos_noise}_d={num_distractors}_const"
    sim = DiskSimulator(im_size, sequence_length, num_distractors, pos_noise)

    # total sequences so that ~num_examples land in train (80%)
    total = int(np.ceil(num_examples / 0.8))
    written = 0
    index = 0
    while written < total:
        chunk = min(file_size, total - written)
        data = sim.generate_batch(generator, chunk)
        perm = np.random.default_rng(seed + index).permutation(chunk)
        data = {k: v[perm] for k, v in data.items()}
        train_n = int(np.floor(chunk * 0.8))
        val_n = int(np.floor(chunk * 0.1))
        splits = {
            "train": (0, train_n),
            "val": (train_n, train_n + val_n),
            "test": (train_n + val_n, chunk),
        }
        for split, (lo, hi) in splits.items():
            if hi <= lo:
                continue
            payload = {k: v[lo:hi] for k, v in data.items()}
            np.savez(
                os.path.join(out_dir, f"{full_name}{index}_{split}.npz"),
                **{f"{split}_data": payload},
            )
        written += chunk
        index += 1


def _cli(argv=None) -> None:
    """Standalone dataset generation on the GPU, with the reference
    generator's defaults (1000 examples, file_size 500, 25 distractors,
    pos-noise 2.0, T=50, 128 px).  Run as ``python -m nfdpf_torch.data.simulator``."""
    import argparse

    p = argparse.ArgumentParser(description=_cli.__doc__)
    p.add_argument("--out-dir", default="./TwentyfiveDistractors")
    p.add_argument("--num-examples", type=int, default=1000)
    p.add_argument("--file-size", type=int, default=500)
    p.add_argument("--num-distractors", type=int, default=25)
    p.add_argument("--pos-noise", type=float, default=2.0)
    p.add_argument("--sequence-length", type=int, default=50)
    p.add_argument("--im-size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--name", default="toy")
    a = p.parse_args(argv)
    generate_dataset(a.out_dir, num_examples=a.num_examples,
                     file_size=a.file_size,
                     num_distractors=a.num_distractors,
                     pos_noise=a.pos_noise,
                     sequence_length=a.sequence_length,
                     im_size=a.im_size, seed=a.seed, name=a.name)
    print(f"wrote dataset shards to {a.out_dir}")


if __name__ == "__main__":
    _cli()
