"""1D localization tutorial on the PyTorch port — the minimal API exemplar.

The port of ``examples/tutorial_1d.py`` (beluga_tutorial/src/main.cpp): a
robot moves along a 1D corridor at constant velocity past known landmarks;
particles are plain scalars (the particle storage and resampling are
generic over the state tree).

Per cycle: propagate (velocity + Gaussian noise) → reweight (product of
per-landmark range Gaussians + minimum weight) → normalize → weighted
mean/variance estimate → systematic resample.  The cycle takes its draws
(the motion normals and the systematic uniform) as inputs; ``main`` draws
them from one ``torch.Generator``.

Run: python examples/torch_tutorial_1d.py [--device cpu]
(on the card by default; ``--device cpu`` runs the plain PyTorch versions)
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from beluga_tpu_torch import ParticleSet, make_from_states, resolve_device  # noqa: E402
from beluga_tpu_torch.algorithms.estimation import estimate_scalar  # noqa: E402
from beluga_tpu_torch.core.weights import normalize  # noqa: E402
from beluga_tpu_torch.ops.resample import search_indices, systematic_from_uniform  # noqa: E402


@dataclasses.dataclass(frozen=True)
class TutorialParams:
    """Mirrors beluga::tutorial::Parameters (main.cpp:40-110)."""

    map_size: int = 100
    number_of_particles: int = 300
    number_of_cycles: int = 100
    initial_position: float = 0.0
    initial_position_sigma: float = 10.0
    dt: float = 1.0
    velocity: float = 1.0
    motion_model_sigma: float = 1.0
    sensor_range: float = 3.0
    sensor_model_sigma: float = 1.0
    min_particle_weight: float = 0.08


LANDMARKS = (5.0, 12.0, 25.0, 37.0, 52.0, 55.0, 65.0, 74.0, 85.0, 95.0)


def sense(position: float, landmarks: torch.Tensor, sensor_range: float):
    """Ranges to the landmarks and which lie within the sensor's field of view."""
    d = landmarks - position
    return d, torch.abs(d) <= sensor_range


def cycle(p: TutorialParams, landmarks: torch.Tensor, particles: ParticleSet,
          measurement: torch.Tensor, meas_mask: torch.Tensor, normals: torch.Tensor,
          u0: torch.Tensor):
    """One cycle from its draws: ``normals`` f32[N] standard normals for the
    motion, ``u0`` f32[] the systematic resampler's uniform.  Returns the
    resampled particles and the estimate ``(mean, variance)`` taken before
    resampling."""
    n = particles.capacity
    # propagate: x += v dt + noise (main.cpp motion update)
    states = particles.state + p.velocity * p.dt + normals * p.motion_model_sigma

    # reweight: product over detections of range Gaussians, at least the minimum weight
    err = (landmarks[None, :] - states[:, None]) - measurement[None, :]  # [N, L]
    pz = torch.exp(-torch.square(err) / (2.0 * p.sensor_model_sigma**2))
    pz = torch.where(meas_mask[None, :], pz, 1.0)
    lik = torch.clamp_min(torch.prod(pz, dim=-1), p.min_particle_weight)
    particles = normalize(ParticleSet(states, particles.log_weight + torch.log(lik),
                                      particles.active))

    mean, var = estimate_scalar(particles.state, particles.weight, particles.mask)

    # systematic resample back to N particles of weight 1
    idx = search_indices(particles.weight, systematic_from_uniform(u0, n))
    return make_from_states(particles.state[idx.long()]), (mean, var)


def main(device=None, seed: int = 0, p: TutorialParams = TutorialParams()) -> float:
    """Run the tutorial on ``device`` (the card unless told otherwise) and
    return the mean absolute error over the second half of the cycles."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    landmarks = torch.tensor(LANDMARKS, dtype=torch.float32, device=dev)
    n = p.number_of_particles
    init = p.initial_position + p.initial_position_sigma * torch.randn(
        n, generator=gen, device=dev)
    particles = make_from_states(init)

    true_pos = p.initial_position
    errors = []
    for t in range(p.number_of_cycles):
        true_pos += p.velocity * p.dt
        if true_pos > p.map_size:
            break
        meas, mask = sense(true_pos, landmarks, p.sensor_range)
        normals = torch.randn(n, generator=gen, device=dev)
        u0 = torch.rand((), generator=gen, device=dev)
        particles, (mean, var) = cycle(p, landmarks, particles, meas, mask, normals, u0)
        mean, var = float(mean), float(var)
        errors.append(abs(mean - true_pos))
        if t % 10 == 0:
            print(f"t={t:3d}  true={true_pos:6.2f}  est={mean:6.2f} "
                  f"sd={var**0.5:5.2f}  err={errors[-1]:5.2f}")
    tail = float(np.mean(errors[len(errors) // 2:]))
    print(f"mean |error| over the second half: {tail:.3f} m ({dev.type})")
    return tail


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(args.device, args.seed)
