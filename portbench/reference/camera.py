"""Arc-rotate camera: math only (counterpart of ``reze_tpu/camera.py``).

A spherical orbit around ``target`` with azimuth ``alpha``, polar angle
``beta`` and ``radius``, in the engine's left-handed conventions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import math3d as m3


@dataclasses.dataclass
class Camera:
    alpha: float = np.pi
    beta: float = np.pi / 2.5
    radius: float = 26.6
    target: tuple[float, float, float] = (0.0, 12.5, 0.0)
    fov: float = np.pi / 4
    aspect: float = 1.0
    near: float = 0.05
    far: float = 1000.0
    angular_sensitivity: float = 0.005
    pan_sensitivity: float = 0.0002
    wheel_precision: float = 0.01
    lower_beta_limit: float = 0.001
    upper_beta_limit: float = np.pi - 0.001

    def position(self, device="cuda") -> torch.Tensor:
        t = torch.tensor(self.target, dtype=torch.float32, device=device)
        sb, cb = np.sin(self.beta), np.cos(self.beta)
        sa, ca = np.sin(self.alpha), np.cos(self.alpha)
        offset = torch.tensor([sb * sa, cb, sb * ca], dtype=torch.float32,
                              device=device)
        return t + self.radius * offset

    def view_matrix(self, device="cuda") -> torch.Tensor:
        return m3.look_at_lh(
            self.position(device),
            torch.tensor(self.target, dtype=torch.float32, device=device),
            torch.tensor([0.0, 1.0, 0.0], device=device),
        )

    def projection_matrix(self, device="cuda") -> torch.Tensor:
        return m3.perspective_lh(self.fov, self.aspect, self.near, self.far,
                                 device=device)

    def view_proj(self, device="cuda") -> torch.Tensor:
        return self.projection_matrix(device) @ self.view_matrix(device)

    def orbit(self, dx: float, dy: float) -> "Camera":
        alpha = self.alpha - dx * self.angular_sensitivity
        beta = float(np.clip(self.beta - dy * self.angular_sensitivity,
                             self.lower_beta_limit, self.upper_beta_limit))
        return dataclasses.replace(self, alpha=alpha, beta=beta)

    def zoom(self, delta: float) -> "Camera":
        radius = float(np.clip(self.radius + delta * self.wheel_precision, 0.1, self.far))
        return dataclasses.replace(self, radius=radius)

    def pan(self, dx: float, dy: float) -> "Camera":
        eye = self.position("cpu").numpy()
        fwd = np.asarray(self.target) - eye
        fl = np.linalg.norm(fwd)
        if fl < 1e-4:
            right, up = np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
        else:
            fwd = fwd / fl
            right = np.cross([0.0, 1.0, 0.0], fwd)
            rl = np.linalg.norm(right)
            right = np.array([1.0, 0, 0]) if rl < 1e-4 else right / rl
            up = np.cross(fwd, right)
            ul = np.linalg.norm(up)
            up = np.array([0, 1.0, 0]) if ul < 1e-4 else up / ul
        dist = self.radius * self.pan_sensitivity
        target = np.asarray(self.target) + right * (-dx * dist) + up * (dy * dist)
        return dataclasses.replace(self, target=tuple(target))
