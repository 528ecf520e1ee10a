"""Batched SO2 / SE2 over dense tensors (port of ``beluga_tpu/lie.py``).

Every type is a structure of tensors with arbitrary leading batch
dimensions: a particle cloud of N poses is ``SE2(xy=f32[N, 2],
rot=SO2(z=f32[N, 2]))``.  SO2 is a unit complex number ``(cos, sin)``.

The arithmetic keeps the reference's operation order exactly (for example
``c1*c2 - s1*s2``): downstream cell indices are ``floor(x / res)``, and a
reassociated sum can move a point across a cell edge.  SO3/SE3 arrive with
ROADMAP item A12.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SO2:
    """Planar rotation as a unit complex number, ``z[..., 2] = (cos, sin)``."""

    z: Tensor

    @property
    def cos(self) -> Tensor:
        return self.z[..., 0]

    @property
    def sin(self) -> Tensor:
        return self.z[..., 1]

    @staticmethod
    def identity(shape=(), device=None, dtype=torch.float32) -> "SO2":
        z = torch.zeros((*shape, 2), dtype=dtype, device=device)
        z[..., 0] = 1.0
        return SO2(z)

    @staticmethod
    def exp(theta: Tensor) -> "SO2":
        return SO2(torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1))

    def log(self) -> Tensor:
        """Rotation angle in (-pi, pi]."""
        return torch.atan2(self.sin, self.cos)

    def __matmul__(self, other):
        if isinstance(other, SO2):
            c = self.cos * other.cos - self.sin * other.sin
            s = self.sin * other.cos + self.cos * other.sin
            return SO2(torch.stack([c, s], dim=-1))
        return self.act(other)

    def act(self, v: Tensor) -> Tensor:
        """Rotate 2D points ``v[..., 2]``."""
        x = self.cos * v[..., 0] - self.sin * v[..., 1]
        y = self.sin * v[..., 0] + self.cos * v[..., 1]
        return torch.stack([x, y], dim=-1)

    def inverse(self) -> "SO2":
        return SO2(torch.stack([self.cos, -self.sin], dim=-1))

    def normalized(self) -> "SO2":
        return SO2(self.z / torch.linalg.vector_norm(self.z, dim=-1, keepdim=True))

    @property
    def shape(self):
        return self.z.shape[:-1]


@dataclasses.dataclass(frozen=True)
class SE2:
    """Planar rigid transform: translation ``xy[..., 2]`` and rotation ``rot``."""

    xy: Tensor
    rot: SO2

    @property
    def x(self) -> Tensor:
        return self.xy[..., 0]

    @property
    def y(self) -> Tensor:
        return self.xy[..., 1]

    @property
    def theta(self) -> Tensor:
        return self.rot.log()

    @property
    def device(self) -> torch.device:
        return self.xy.device

    @staticmethod
    def identity(shape=(), device=None, dtype=torch.float32) -> "SE2":
        return SE2(
            torch.zeros((*shape, 2), dtype=dtype, device=device),
            SO2.identity(shape, device, dtype),
        )

    @staticmethod
    def from_xytheta(x, y=None, theta=None, device=None) -> "SE2":
        """From an ``[..., 3]`` array or three broadcastable components."""
        if y is None:
            arr = torch.as_tensor(x, dtype=torch.float32, device=device)
            x, y, theta = arr[..., 0], arr[..., 1], arr[..., 2]
        x, y, theta = (
            torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (x, y, theta)
        )
        x, y, theta = torch.broadcast_tensors(x, y, theta)
        return SE2(torch.stack([x, y], dim=-1), SO2.exp(theta))

    def as_xytheta(self) -> Tensor:
        return torch.cat([self.xy, self.theta[..., None]], dim=-1)

    def __matmul__(self, other):
        if isinstance(other, SE2):
            return SE2(self.xy + self.rot.act(other.xy), self.rot @ other.rot)
        return self.act(other)

    def act(self, p: Tensor) -> Tensor:
        """Transform 2D points ``p[..., 2]``."""
        return self.rot.act(p) + self.xy

    def inverse(self) -> "SE2":
        rinv = self.rot.inverse()
        return SE2(-rinv.act(self.xy), rinv)

    def log(self) -> Tensor:
        """Tangent vector ``[..., 3] = (vx, vy, omega)`` (Sophus convention)."""
        theta = self.theta
        half = 0.5 * theta
        small = torch.abs(theta) < 1e-5
        one = torch.ones_like(half)
        a = torch.where(
            small, 1.0 - theta * theta / 12.0, half / torch.tan(torch.where(small, one, half))
        )
        b = half
        vx = a * self.x + b * self.y
        vy = -b * self.x + a * self.y
        return torch.stack([vx, vy, theta], dim=-1)

    @staticmethod
    def exp(tangent: Tensor) -> "SE2":
        """Exponential map from ``[..., 3] = (vx, vy, omega)``."""
        vx, vy, theta = tangent[..., 0], tangent[..., 1], tangent[..., 2]
        small = torch.abs(theta) < 1e-5
        theta_safe = torch.where(small, torch.ones_like(theta), theta)
        sin_over = torch.where(
            small, 1.0 - theta * theta / 6.0, torch.sin(theta_safe) / theta_safe
        )
        one_minus_cos_over = torch.where(
            small, theta / 2.0, (1.0 - torch.cos(theta_safe)) / theta_safe
        )
        x = sin_over * vx - one_minus_cos_over * vy
        y = one_minus_cos_over * vx + sin_over * vy
        return SE2(torch.stack([x, y], dim=-1), SO2.exp(theta))

    @property
    def shape(self):
        return self.xy.shape[:-1]

    def to(self, device) -> "SE2":
        return SE2(self.xy.to(device), SO2(self.rot.z.to(device)))
