"""4x4 rigid transforms and DH link matrices.

Conventions match the reference exactly (helpers/cuda_matrices.h,
robot/dh_robot/KinematicLink.cu:24-89):

* ``from_rpy(roll, pitch, yaw) = Rz(yaw) @ Ry(pitch) @ Rx(roll)``
  (cuda_matrices.h:274-277, "acts like ROS tf setRPY").
* DH link matrix is the standard Denavit-Hartenberg matrix with the joint
  value added to theta (revolute) or d (prismatic).
* Points are column vectors: ``p' = M[:3,:3] @ p + M[:3,3]``.

Everything is float32 and usable both traced (jnp) and on host (np).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

REVOLUTE = 0
PRISMATIC = 1

# GPU float32 matmuls may run in TF32 by default; coordinates feed
# floor()-based voxelization, so every transform here pins full float32
# precision.
_F32 = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """Full-precision matrix multiply (never TF32: safe for coordinates)."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a @ b
    return jnp.matmul(a, b, precision=_F32)


def identity(xp=jnp):
    return xp.eye(4, dtype=xp.float32)


def from_translation(t, xp=jnp):
    m = xp.eye(4, dtype=xp.float32)
    if xp is jnp:
        return m.at[:3, 3].set(xp.asarray(t, dtype=xp.float32))
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def rot_x(roll, xp=jnp):
    c, s = xp.cos(roll), xp.sin(roll)
    z, o = xp.zeros_like(c), xp.ones_like(c)
    return _mat3(xp, [[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(pitch, xp=jnp):
    c, s = xp.cos(pitch), xp.sin(pitch)
    z, o = xp.zeros_like(c), xp.ones_like(c)
    return _mat3(xp, [[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(yaw, xp=jnp):
    c, s = xp.cos(yaw), xp.sin(yaw)
    z, o = xp.zeros_like(c), xp.ones_like(c)
    return _mat3(xp, [[c, -s, z], [s, c, z], [z, z, o]])


def _mat3(xp, rows):
    return xp.stack([xp.stack(r, axis=-1) for r in rows], axis=-2).astype(xp.float32)


def from_rpy(rpy, translation=None, xp=jnp):
    """Matrix4f::createFromRotationAndTranslation(Matrix3f::createFromRPY(rpy), t).

    Rotation = Rz(yaw) @ Ry(pitch) @ Rx(roll) (cuda_matrices.h:274-277).
    """
    rpy = xp.asarray(rpy, dtype=xp.float32)
    if xp is np:
        r3 = rot_z(rpy[..., 2], xp) @ rot_y(rpy[..., 1], xp) @ rot_x(rpy[..., 0], xp)
    else:
        r3 = matmul(matmul(rot_z(rpy[..., 2], xp), rot_y(rpy[..., 1], xp)), rot_x(rpy[..., 0], xp))
    return compose(r3, translation, xp)


def compose(rot3, translation=None, xp=jnp):
    """Build a 4x4 from a 3x3 rotation and a translation."""
    rot3 = xp.asarray(rot3, dtype=xp.float32)
    batch = rot3.shape[:-2]
    m = xp.zeros(batch + (4, 4), dtype=xp.float32)
    if xp is jnp:
        m = m.at[..., :3, :3].set(rot3)
        if translation is not None:
            m = m.at[..., :3, 3].set(xp.asarray(translation, dtype=xp.float32))
        m = m.at[..., 3, 3].set(1.0)
        return m
    m[..., :3, :3] = rot3
    if translation is not None:
        m[..., :3, 3] = np.asarray(translation, dtype=np.float32)
    m[..., 3, 3] = 1.0
    return m


def dh_matrix(d, theta, a, alpha, value, joint_type=REVOLUTE, xp=jnp):
    """DHParameters::convertDHtoM (KinematicLink.cu:24-89), b == 0.

    Revolute joints add `value` to theta; prismatic joints add it to d.
    """
    d = xp.asarray(d, dtype=xp.float32)
    theta = xp.asarray(theta, dtype=xp.float32)
    a = xp.asarray(a, dtype=xp.float32)
    alpha = xp.asarray(alpha, dtype=xp.float32)
    value = xp.asarray(value, dtype=xp.float32)
    if joint_type == PRISMATIC:
        d_c, th_c = d + value, theta
    else:
        d_c, th_c = d, theta + value
    ca, sa = xp.cos(alpha), xp.sin(alpha)
    ct, st = xp.cos(th_c), xp.sin(th_c)
    z = xp.zeros_like(ct)
    o = xp.ones_like(ct)
    rows = [
        [ct, -st * ca, st * sa, a * ct],
        [st, ct * ca, -ct * sa, a * st],
        [z, sa, ca, d_c],
        [z, z, z, o],
    ]
    return xp.stack([xp.stack(r, axis=-1) for r in rows], axis=-2).astype(xp.float32)


def axis_angle(axis, angle, xp=jnp):
    """3x3 rotation about a (normalized) axis by angle (Rodrigues)."""
    axis = xp.asarray(axis, dtype=xp.float32)
    axis = axis / xp.sqrt(xp.sum(axis * axis) + xp.float32(1e-30))
    x, y, z = axis[0], axis[1], axis[2]
    c, s = xp.cos(angle), xp.sin(angle)
    C = 1.0 - c
    rows = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return xp.stack([xp.stack([xp.asarray(e, dtype=xp.float32) for e in r], axis=-1) for r in rows], axis=-2)


def transform_points(matrix, points):
    """Apply a 4x4 (or batch of per-point 4x4s) to [N,3] points.

    Equivalent of kernelTransformCloud (helpers/kernels/MetaPointCloudOperations.h:36-53),
    expressed as one fused matmul + add for the MXU/VPU.
    """
    matrix = jnp.asarray(matrix, dtype=jnp.float32)
    points = jnp.asarray(points, dtype=jnp.float32)
    rot = matrix[..., :3, :3]
    t = matrix[..., :3, 3]
    if matrix.ndim == 2:
        return jnp.matmul(points, rot.T, precision=_F32) + t
    # per-point matrices: [N,3,3] @ [N,3] + [N,3]
    return jnp.einsum("nij,nj->ni", rot, points, precision=_F32) + t


def to_rpy(matrix, solution: int = 1, xp=jnp):
    """Matrix3f::toRPY (cuda_matrices.h:285-326): rotation -> (roll, pitch, yaw).

    Two solution branches (`solution` 1 or 2, the reference default is 1) and
    the reference's gimbal-lock handling: when ``1 - |a31| < 1e-5`` both
    solutions coincide with yaw pinned to 0 and pitch at ±pi/2. Inverse of
    `from_rpy` (solution 1 when |pitch| < pi/2). Accepts 3x3 or 4x4 inputs,
    batched; jit-safe (branchless selects).
    """
    m = xp.asarray(matrix, dtype=xp.float32)
    r = m[..., :3, :3]
    a11, a12, a13 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    a21 = r[..., 1, 0]
    a31, a32, a33 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    singular = (1.0 - xp.abs(a31)) < xp.float32(1e-5)
    y1 = -xp.arcsin(xp.clip(a31, -1.0, 1.0))
    y = y1 if solution == 1 else xp.float32(np.pi) - y1
    cy = xp.cos(y)
    safe = xp.where(singular, xp.ones_like(cy), cy)
    x = xp.arctan2(a32 / safe, a33 / safe)
    z = xp.arctan2(a21 / safe, a11 / safe)

    locked_down = a31 < 0  # pitch = +pi/2 (cuda_matrices.h:297-304)
    xs = xp.where(locked_down, xp.arctan2(a12, a13), xp.arctan2(-a12, -a13))
    ys = xp.where(locked_down, xp.float32(np.pi / 2), xp.float32(-np.pi / 2))

    roll = xp.where(singular, xs, x)
    pitch = xp.where(singular, ys, y)
    yaw = xp.where(singular, xp.zeros_like(z), z)
    return xp.stack([roll, pitch, yaw], axis=-1).astype(xp.float32)


def invert(matrix, xp=jnp):
    """Rigid-transform inverse (rotation transpose + back-rotated translation)."""
    rot = matrix[..., :3, :3]
    t = matrix[..., :3, 3]
    rt = xp.swapaxes(rot, -1, -2)
    if xp is np:
        ti = -(rt @ t[..., None])[..., 0]
    else:
        ti = -matmul(rt, t[..., None])[..., 0]
    return compose(rt, ti, xp)
