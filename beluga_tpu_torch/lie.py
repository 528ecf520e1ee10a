"""Batched SO2 / SE2 over dense tensors (port of ``beluga_tpu/lie.py``).

Every type is a structure of tensors with arbitrary leading batch
dimensions: a particle cloud of N poses is ``SE2(xy=f32[N, 2],
rot=SO2(z=f32[N, 2]))``.  SO2 is a unit complex number ``(cos, sin)``.

The arithmetic keeps the reference's operation order exactly (for example
``c1*c2 - s1*s2``): downstream cell indices are ``floor(x / res)``, and a
reassociated sum can move a point across a cell edge.  SO3 is a unit
quaternion ``q[..., 4] = (w, x, y, z)``; ``to_3d`` and ``to_2d`` embed the
plane in space and project back (3d_embedding.hpp:23-36).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """``a × b`` over the last axis, in ``jnp.cross``'s operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _norm(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis, keeping it: ``sqrt(Σ v²)``."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


@dataclasses.dataclass(frozen=True)
class SO3:
    """3D rotation as a unit quaternion ``q[..., 4] = (w, x, y, z)``."""

    q: Tensor

    @staticmethod
    def identity(shape=(), device=None, dtype=torch.float32) -> "SO3":
        q = torch.zeros((*shape, 4), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return SO3(q)

    @staticmethod
    def from_quat_wxyz(q: Tensor) -> "SO3":
        return SO3(q / _norm(q))

    @staticmethod
    def exp(w: Tensor) -> "SO3":
        """Exponential map from rotation vectors ``w[..., 3]``."""
        angle = _norm(w)
        small = angle < 1e-6
        angle_safe = torch.where(small, torch.ones_like(angle), angle)
        half = 0.5 * angle
        sinc_half = torch.where(small, 0.5 - angle * angle / 48.0,
                                torch.sin(half) / angle_safe)
        return SO3(torch.cat([torch.cos(half), sinc_half * w], dim=-1))

    def log(self) -> Tensor:
        """Rotation vector ``[..., 3]``, on the shortest arc (w >= 0)."""
        qw, qv = self.q[..., :1], self.q[..., 1:]
        sign = torch.where(qw < 0, -1.0, 1.0)
        qw, qv = qw * sign, qv * sign
        norm_v = _norm(qv)
        small = norm_v < 1e-6
        norm_safe = torch.where(small, torch.ones_like(norm_v), norm_v)
        angle = 2.0 * torch.atan2(norm_v, qw)
        scale = torch.where(small, 2.0 / torch.clamp_min(qw, 1e-6), angle / norm_safe)
        return scale * qv

    def __matmul__(self, other):
        if isinstance(other, SO3):
            w1, x1, y1, z1 = self.q.unbind(-1)
            w2, x2, y2, z2 = other.q.unbind(-1)
            return SO3(torch.stack([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ], dim=-1))
        return self.act(other)

    def act(self, v: Tensor) -> Tensor:
        """Rotate 3D points ``v[..., 3]``: ``v + w·t + qv × t`` with
        ``t = 2·(qv × v)``."""
        qw, qv = self.q[..., :1], self.q[..., 1:]
        t = 2.0 * _cross(qv, v)
        return v + qw * t + _cross(qv, t)

    def inverse(self) -> "SO3":
        return SO3(torch.cat([self.q[..., :1], -self.q[..., 1:]], dim=-1))

    def as_matrix(self) -> Tensor:
        w, x, y, z = self.q.unbind(-1)
        r = torch.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], dim=-1)
        return r.reshape(*r.shape[:-1], 3, 3)

    @staticmethod
    def from_rpy(roll, pitch, yaw) -> "SO3":
        """Extrinsic XYZ Euler angles: ``exp(yaw ẑ) · (exp(pitch ŷ) ·
        exp(roll x̂))``."""
        roll, pitch, yaw = (torch.as_tensor(a, dtype=torch.float32) for a in (roll, pitch, yaw))
        zero = torch.zeros_like(yaw)
        return SO3.exp(torch.stack([zero, zero, yaw], -1)) @ (
            SO3.exp(torch.stack([torch.zeros_like(pitch), pitch, torch.zeros_like(pitch)], -1))
            @ SO3.exp(torch.stack([roll, torch.zeros_like(roll), torch.zeros_like(roll)], -1))
        )

    def rpy(self) -> tuple[Tensor, Tensor, Tensor]:
        """Extrinsic XYZ Euler angles (roll, pitch, yaw) from the matrix."""
        m = self.as_matrix()
        pitch = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
        roll = torch.atan2(m[..., 2, 1], m[..., 2, 2])
        yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
        return roll, pitch, yaw

    @property
    def shape(self):
        return self.q.shape[:-1]


@dataclasses.dataclass(frozen=True)
class SE3:
    """3D rigid transform: translation ``xyz[..., 3]`` and rotation ``rot``."""

    xyz: Tensor
    rot: SO3

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @staticmethod
    def identity(shape=(), device=None, dtype=torch.float32) -> "SE3":
        return SE3(torch.zeros((*shape, 3), dtype=dtype, device=device),
                   SO3.identity(shape, device, dtype))

    @staticmethod
    def from_xyzrpy(xyz, rpy, device=None) -> "SE3":
        """From a translation ``[..., 3]`` and (roll, pitch, yaw), float32."""
        xyz = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
        roll, pitch, yaw = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                            for a in rpy)
        return SE3(xyz, SO3.from_rpy(roll, pitch, yaw))

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.xyz + self.rot.act(other.xyz), self.rot @ other.rot)
        return self.act(other)

    def act(self, p: Tensor) -> Tensor:
        return self.rot.act(p) + self.xyz

    def inverse(self) -> "SE3":
        rinv = self.rot.inverse()
        return SE3(-rinv.act(self.xyz), rinv)

    def log(self) -> Tensor:
        """Tangent ``[..., 6] = (v, omega)``, translation first (Sophus
        order), through the closed form of ``V⁻¹ t``."""
        w = self.rot.log()
        angle = _norm(w)
        small = angle < 1e-6
        angle_safe = torch.where(small, torch.ones_like(angle), angle)
        half = 0.5 * angle
        cot_half = torch.where(small, 2.0 / angle_safe,
                               torch.cos(half) / torch.clamp_min(torch.sin(half), 1e-30))
        k = torch.where(small, angle * angle / 12.0, 1.0 - 0.5 * angle * cot_half)
        t = self.xyz
        wxt = _cross(w, t)
        wxwxt = _cross(w, wxt)
        a2 = torch.where(small, torch.ones_like(angle), angle_safe * angle_safe)
        coef = torch.where(small, torch.full_like(angle, 1.0 / 12.0), k / a2)
        v = t - 0.5 * wxt + coef * wxwxt
        return torch.cat([v, w], dim=-1)

    @staticmethod
    def exp(tangent: Tensor) -> "SE3":
        v, w = tangent[..., :3], tangent[..., 3:]
        rot = SO3.exp(w)
        angle = _norm(w)
        small = angle < 1e-6
        a = torch.where(small, torch.ones_like(angle), angle)
        big_a = torch.where(small, 1.0 - angle * angle / 6.0, torch.sin(a) / a)
        big_b = torch.where(small, 0.5 - angle * angle / 24.0, (1.0 - torch.cos(a)) / (a * a))
        big_c = torch.where(small, 1.0 / 6.0 - angle * angle / 120.0, (1.0 - big_a) / (a * a))
        wxv = _cross(w, v)
        return SE3(v + big_b * wxv + big_c * _cross(w, wxv), rot)

    @property
    def shape(self):
        return self.xyz.shape[:-1]

    def to(self, device) -> "SE3":
        return SE3(self.xyz.to(device), SO3(self.rot.q.to(device)))


def to_3d(pose: SE2) -> SE3:
    """Embed an SE2 pose in SE3 on the z = 0 plane."""
    zeros = torch.zeros_like(pose.x)
    half = 0.5 * pose.theta
    q = torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)
    return SE3(torch.stack([pose.x, pose.y, zeros], dim=-1), SO3(q))


def to_2d(pose: SE3) -> SE2:
    """Project an SE3 pose on the z = 0 plane, keeping its yaw."""
    _, _, yaw = pose.rot.rpy()
    return SE2(pose.xyz[..., :2], SO2.exp(yaw))
