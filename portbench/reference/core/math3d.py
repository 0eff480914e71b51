"""3D math on tensors (counterpart of ``reze_tpu/core/math3d.py``).

Same conventions: left-handed, +Z forward, +Y up; quaternions ``[x, y, z,
w]`` with Hamilton products; MMD ZXY Euler order; matrices ``(..., 4, 4)``
acting on column vectors. Every function broadcasts over leading axes.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


_CONSTS: dict = {}


def const(values: tuple, dtype=torch.float32, device="cuda") -> Tensor:
    """A constant tensor of ``values``, made once per device and dtype and
    then reused: copying host values to the card waits for its stream, so
    a per-call copy would stall every step. For a few fixed values only;
    raises if a caller wrote to the shared tensor in place."""
    key = (values, dtype, torch.device(device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    elif c._version:
        raise RuntimeError(f"the shared constant {values} was written in place")
    return c


def take_rows(tab: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` of ``tab`` (..., M, K) -> (..., N, K): ids (N,) shared
    by the leading axes, or each leading index's own (..., N)."""
    idx = idx.expand(tab.shape[:-2] + idx.shape[-1:])
    return torch.gather(tab, -2, idx[..., None].expand(idx.shape + tab.shape[-1:]))


def morph_sum(weights: Tensor, table: Tensor) -> Tensor:
    """sum_m weights[..., m] * table[m] -> (..., *table.shape[1:]), summed
    in float64 and rounded once. A float32 matrix product sums in an order
    that depends on its batch (a matrix-vector product for one character,
    a matrix product for a crowd), so a crowd's morphed rows would differ
    in the last bit from its characters' own; rounded once from float64,
    they agree."""
    return torch.tensordot(weights.double(), table.double(), dims=([-1], [0])).to(table.dtype)


def sum3(x: Tensor, dim: int = -1) -> Tensor:
    """The sum over a 3-long axis in one fixed order, (x0 + x1) + x2: a
    reduction kernel may add three terms in another order on another
    device, and a last-bit difference in a plane coefficient moves a depth
    tie."""
    a, b, c = x.unbind(dim)
    return (a + b) + c


def ease_in_out(t: Tensor) -> Tensor:
    """Quadratic ease-in-out."""
    return torch.where(t < 0.5, 2.0 * t * t, 1.0 - torch.square(-2.0 * t + 2.0) / 2.0)


def quat_identity(shape=(), device="cuda") -> Tensor:
    """Identity quaternions of ``shape`` -> (*shape, 4)."""
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return q * const((-1.0, -1.0, -1.0, 1.0), q.dtype, q.device)


def quat_normalize(q: Tensor, eps: float = 0.0) -> Tensor:
    """Normalize; zero length becomes identity."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    out = q / torch.where(n > eps, n, torch.ones_like(n))
    ident = const((0.0, 0.0, 0.0, 1.0), q.dtype, q.device).expand(q.shape)
    return torch.where(n > eps, out, ident)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_slerp(a: Tensor, b: Tensor, t) -> Tensor:
    """Shortest-path slerp with an nlerp fallback above cos > 0.9995."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)[..., None]
    cos = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(cos < 0.0, -b, b)
    cos = torch.abs(cos)

    lin = a + t * (b - a)
    lin = lin / torch.linalg.norm(lin, dim=-1, keepdim=True)

    cos_c = torch.clamp(cos, -1.0, 0.99951)
    theta0 = torch.arccos(cos_c)
    sin_theta0 = torch.sin(theta0)
    theta = theta0 * t
    s0 = torch.sin(theta0 - theta) / sin_theta0
    s1 = torch.sin(theta) / sin_theta0
    sph = s0 * a + s1 * b
    return torch.where(cos > 0.9995, lin, sph)


def quat_from_rotvec(rv: Tensor) -> Tensor:
    """Rotation vector (axis * angle) -> quaternion (exp map)."""
    angle = torch.linalg.norm(rv, dim=-1, keepdim=True)
    half = 0.5 * angle
    sinc = torch.where(angle > 1e-8,
                       torch.sin(half) / torch.clamp(angle, min=1e-12),
                       torch.full_like(angle, 0.5))
    return torch.cat([rv * sinc, torch.cos(half)], dim=-1)


def quat_from_euler_zxy(rot: Tensor) -> Tensor:
    """MMD Euler (rotX, rotY, rotZ), ZXY order -> quaternion."""
    half = 0.5 * rot
    sx, sy, sz = torch.sin(half).unbind(-1)
    cx, cy, cz = torch.cos(half).unbind(-1)
    w = cy * cx * cz + sy * sx * sz
    x = cy * sx * cz + sy * cx * sz
    y = sy * cx * cz - cy * sx * sz
    z = cy * cx * sz - sy * sx * cz
    return quat_normalize(torch.stack([x, y, z, w], dim=-1))


def quat_to_euler_zxy(q: Tensor) -> Tensor:
    """Euler extraction with the reference engine's formulas (an
    approximate inverse of :func:`quat_from_euler_zxy`)."""
    qx, qy, qz, qw = q.unbind(-1)
    rot_x = torch.atan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    sinp = 2.0 * (qw * qy - qz * qx)
    rot_y = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    rot_z = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return torch.stack([rot_x, rot_y, rot_z], dim=-1)


def quat_from_to(v_from: Tensor, v_to: Tensor) -> Tensor:
    """The quaternion that turns unit vector ``v_from`` onto ``v_to``; the
    identity where they agree, a half turn about an axis orthogonal to
    ``v_from`` where they are opposite."""
    d = torch.sum(v_from * v_to, dim=-1, keepdim=True)
    w = torch.sqrt(torch.clamp((1.0 + d) * 2.0, min=1e-12))
    general = torch.cat([torch.linalg.cross(v_from, v_to) / w, 0.5 * w], dim=-1)
    alt1 = torch.linalg.cross(v_from, const((1.0, 0.0, 0.0), v_from.dtype, v_from.device)
                              .expand(v_from.shape))
    alt2 = torch.linalg.cross(v_from, const((0.0, 1.0, 0.0), v_from.dtype, v_from.device)
                              .expand(v_from.shape))
    alt = torch.where(torch.linalg.norm(alt1, dim=-1, keepdim=True) < 1e-3, alt2, alt1)
    flip = torch.cat([alt, torch.zeros_like(d)], dim=-1)
    ident = const((0.0, 0.0, 0.0, 1.0), general.dtype, general.device).expand(general.shape)
    out = torch.where(d > 0.999999, ident, torch.where(d < -0.999999, flip, general))
    return quat_normalize(out)


def mat3_from_quat(q: Tensor) -> Tensor:
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    row0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def mat4_from_rot_pos(rot3: Tensor, pos: Tensor) -> Tensor:
    batch = torch.broadcast_shapes(rot3.shape[:-2], pos.shape[:-1])
    rot3 = rot3.expand(batch + (3, 3))
    pos = pos.expand(batch + (3,))
    top = torch.cat([rot3, pos[..., :, None]], dim=-1)
    bottom = const((0.0, 0.0, 0.0, 1.0), rot3.dtype, rot3.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def mat4_from_quat(q: Tensor) -> Tensor:
    return mat4_from_rot_pos(mat3_from_quat(q), torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype,
                                                            device=q.device))


def mat4_from_pos_quat(pos: Tensor, q: Tensor) -> Tensor:
    return mat4_from_rot_pos(mat3_from_quat(q), pos)


def mat4_translation(t: Tensor) -> Tensor:
    return mat4_from_rot_pos(torch.eye(3, dtype=t.dtype, device=t.device), t)


def mat4_to_quat(m: Tensor) -> Tensor:
    """Rotation block of (..., 4, 4) -> unit quaternion, without branches:
    the candidate of the largest diagonal term is kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    trace = m00 + m11 + m22

    def scale(s_sq):
        return torch.sqrt(torch.clamp(s_sq, min=1e-12)) * 2.0

    s = scale(trace + 1.0)
    c0 = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], dim=-1)
    s = scale(1.0 + m00 - m11 - m22)
    c1 = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], dim=-1)
    s = scale(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], dim=-1)
    s = scale(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], dim=-1)
    use0 = (trace > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    q = torch.where(use0, c0, torch.where(use1, c1, torch.where(use2, c2, c3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat4_inverse_rigid(m: Tensor) -> Tensor:
    """Inverse of a rotation + translation: transpose the rotation, rotate
    the translation back."""
    rt = m[..., :3, :3].transpose(-1, -2)
    return mat4_from_rot_pos(rt, -torch.einsum("...ij,...j->...i", rt, m[..., :3, 3]))


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def mat4_inverse(m: Tensor) -> Tensor:
    # inv_ex: linalg.inv reads the solver's status back to the host
    return torch.linalg.inv_ex(m).inverse


def perspective_lh(fov: float, aspect: float, near: float, far: float,
                   device="cuda") -> Tensor:
    """Left-handed perspective, depth in [0 (near), 1 (far)]; each argument
    a number or a 0-d tensor. The entries are rounded to float32 in the
    same order as the JAX version."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    fov, aspect, near, far = f32(fov), f32(aspect), f32(near), f32(far)
    f = 1.0 / torch.tan(fov / 2.0)
    range_inv = 1.0 / (far - near)
    z = torch.zeros_like(f)
    one = torch.ones_like(f)
    return torch.stack([
        torch.stack([f / aspect, z, z, z]),
        torch.stack([z, f, z, z]),
        torch.stack([z, z, (far + near) * range_inv, -near * far * range_inv * 2.0]),
        torch.stack([z, z, one, z]),
    ])


def look_at_lh(eye: Tensor, target: Tensor, up: Tensor) -> Tensor:
    """Left-handed look-at: the camera looks along +Z."""
    def norm(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    forward = norm(target - eye)
    right = norm(torch.linalg.cross(up, forward))
    up_vec = norm(torch.linalg.cross(forward, right))
    rot = torch.stack([right, up_vec, forward], dim=-2)
    trans = torch.stack([
        -torch.sum(right * eye, dim=-1),
        -torch.sum(up_vec * eye, dim=-1),
        -torch.sum(forward * eye, dim=-1),
    ], dim=-1)
    return mat4_from_rot_pos(rot, trans)
