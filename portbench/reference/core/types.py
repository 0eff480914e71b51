"""Engine configuration and the frozen dataclasses of tensors that carry a
model and its per-frame state (counterpart of ``reze_tpu/core/types.py``).

Field names, shapes and padding are those of the JAX package, so a model
built by either package maps onto the other field by field
(``reze_tpu_torch.bridge``). Integer tables are ``int64`` (torch's index
type), flags ``bool``, everything else ``float32``. Static metadata (real
counts, class ranges, feature flags) stays plain Python.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Same fields and defaults as ``reze_tpu.core.types.EngineConfig``."""

    width: int = 1280
    height: int = 720
    ambient: float = 1.0
    bloom_intensity: float = 0.12
    bloom_threshold: float = 0.3
    bloom_downscale: int = 2
    rim_light_intensity: float = 0.45
    camera_distance: float = 26.6
    camera_target: tuple[float, float, float] = (0.0, 12.5, 0.0)
    camera_alpha: float = np.pi
    camera_beta: float = np.pi / 2.5
    camera_fov: float = np.pi / 4
    camera_near: float = 0.05
    camera_far: float = 1000.0
    msaa_samples: int = 4
    # "msaa": per-sample depth tests with coverage-to-alpha; "analytic":
    # one centre depth test + fractional coverage from edge distances
    msaa_mode: str = "msaa"
    msaa_resolve: str = "coverage"
    stencil_eye_value: int = 1
    outline_scale: float = 0.01
    gravity: tuple[float, float, float] = (0.0, -98.0, 0.0)
    physics_fixed_dt: float = 1.0 / 75.0
    physics_max_substeps: int = 10
    physics_solver_iterations: int = 10
    physics_max_contacts: int = 512
    physics_stop_erp: float = 0.475
    enable_physics: bool = True
    enable_ik: bool = True
    enable_bloom: bool = True
    tile_size: int = 64
    max_tris_per_bin: int = 512
    compute_dtype: Any = torch.float32
    renderer: str = "auto"
    layered_shading: bool = True
    # half-res nearest albedo fetch per layer (layer 0 = occluded)
    albedo_half_occluded: bool = True
    albedo_half_visible: bool = True
    albedo_bilinear: bool = False
    albedo_quad: bool = True
    # per-pixel LOD into the dense mip chain (TextureAtlas.mip_flat)
    albedo_mips: bool = True
    use_megakernel: bool = True
    rasterizer: str = "group"
    # static (tile, triangle) pair capacity per pass, as a multiple of the
    # pass's triangle count; overflow is counted in DiagState.pair_overflow
    pair_cap_scale: float = 4.0

    @property
    def bloom_size(self) -> tuple[int, int]:
        return (self.height // self.bloom_downscale, self.width // self.bloom_downscale)


DEFAULT_LIGHTS = (
    ((-0.5, -0.8, 0.5), (1.0, 0.95, 0.9), 0.02),
    ((0.7, -0.5, 0.3), (0.8, 0.85, 1.0), 0.015),
    ((0.3, -0.5, -1.0), (0.9, 0.9, 1.0), 0.01),
)

MAX_LIGHTS = 4

CLASS_OPAQUE = 0
CLASS_EYE = 1
CLASS_HAIR = 2
CLASS_TRANSPARENT = 3
NUM_CLASSES = 4


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


# ---------------------------------------------------------------------------
# Static model tensors
# ---------------------------------------------------------------------------


@_frozen
class Skeleton:
    parent: Tensor  # (J,) -1 = root
    bind_trans: Tensor  # (J, 3)
    inv_bind_trans: Tensor  # (J, 3)
    append_parent: Tensor  # (J,) -1 = none
    append_ratio: Tensor  # (J,)
    append_rotate: Tensor  # (J,) bool
    append_move: Tensor  # (J,) bool
    after_physics: Tensor  # (J,) bool
    n_bones: int
    doubling_steps: int

    @property
    def j(self) -> int:
        return self.parent.shape[0]


@_frozen
class IKChains:
    ik_bone: Tensor  # (C,)
    target: Tensor  # (C,)
    loop_count: Tensor  # (C,)
    limit_angle: Tensor  # (C,)
    links: Tensor  # (C, L) -1 padding, closest-to-effector first
    link_has_limit: Tensor  # (C, L) bool
    link_limit_min: Tensor  # (C, L, 3)
    link_limit_max: Tensor  # (C, L, 3)
    max_loops: int
    n_chains: int

    @property
    def c(self) -> int:
        return self.ik_bone.shape[0]

    @property
    def l(self) -> int:
        return self.links.shape[1]


@_frozen
class Skinning:
    joints: Tensor  # (V, 4)
    weights: Tensor  # (V, 4)
    weights_dense: Tensor | None  # (V, J)
    sdef_c: Tensor | None  # (V, 3)
    sdef_r0: Tensor | None
    sdef_r1: Tensor | None
    is_sdef: Tensor | None  # (V,) bool


@_frozen
class Geometry:
    positions: Tensor  # (V, 3)
    normals: Tensor  # (V, 3)
    uvs: Tensor  # (V, 2)
    tris: Tensor  # (T, 3) class-sorted
    tri_mat: Tensor  # (T,)
    outline_tris: Tensor  # (To, 3)
    outline_tri_mat: Tensor  # (To,)
    n_vertices: int
    class_ranges: tuple  # ((start, count, padded) x 4)
    outline_class_ranges: tuple


@_frozen
class Materials:
    alpha: Tensor  # (M,)
    diffuse_rgb: Tensor  # (M, 3)
    edge_color: Tensor  # (M, 4)
    edge_size: Tensor  # (M,)
    tex_id: Tensor  # (M,) -1 = white
    toon_lut: Tensor  # (M, 256, 3)
    is_eye: Tensor  # (M,) bool
    is_hair: Tensor
    is_transparent: Tensor


@_frozen
class TextureAtlas:
    texels: Tensor  # (N, H, W, 4) uint8
    sizes: Tensor  # (N, 2) (height, width)
    mip_flat: Tensor | None = None  # (S, 4) uint8 dense mip chain
    mip_base: Tensor | None = None  # (N, L) level base rows
    mip_quad: Tensor | None = None  # (S, 16) uint8
    flat_quad: Tensor | None = None  # (N*H*W, 16) uint8


@_frozen
class Morphs:
    offsets: Tensor  # (Nm, V, 3)
    bone_trans: Tensor  # (Nm, J, 3)
    bone_rotvec: Tensor  # (Nm, J, 3)
    uv_offsets: Tensor  # (Nm, V, 2)
    mat_alpha_dmul: Tensor  # (Nm, M)
    mat_alpha_add: Tensor
    mat_edge_a_dmul: Tensor
    mat_edge_a_add: Tensor
    n_morphs: int
    has_bone: bool = False
    has_uv: bool = False
    has_material: bool = False


@_frozen
class PhysicsModel:
    """Rigid-body and joint tables, stepped by ``physics.solver`` when
    ``EngineConfig.enable_physics`` is on (the default)."""

    bone_index: Tensor
    shape: Tensor
    size: Tensor
    mass: Tensor
    inv_mass: Tensor
    inv_inertia_local: Tensor
    linear_damping: Tensor
    angular_damping: Tensor
    restitution: Tensor
    friction: Tensor
    is_dynamic: Tensor
    no_contact: Tensor
    group: Tensor
    collision_mask: Tensor
    body_offset_pos: Tensor
    body_offset_quat: Tensor
    bind_pos: Tensor
    valid: Tensor
    joint_body_a: Tensor
    joint_body_b: Tensor
    joint_pos_a: Tensor
    joint_quat_a: Tensor
    joint_pos_b: Tensor
    joint_quat_b: Tensor
    joint_lin_min: Tensor
    joint_lin_max: Tensor
    joint_ang_min: Tensor
    joint_ang_max: Tensor
    joint_spring_lin: Tensor
    joint_spring_ang: Tensor
    joint_valid: Tensor
    n_bodies: int
    n_joints: int


@_frozen
class AnimationTrack:
    """Per-bone keyframe tables padded to K keys; times padded with +inf."""

    times: Tensor  # (J, K)
    rotations: Tensor  # (J, K, 4)
    positions: Tensor  # (J, K, 3)
    interp: Tensor  # (J, K, 4, 4) Bezier (x1, y1, x2, y2) per channel
    n_keys: Tensor  # (J,)
    has_track: Tensor  # (J,) bool
    morph_times: Tensor  # (Nm, Km)
    morph_values: Tensor  # (Nm, Km)
    morph_n_keys: Tensor  # (Nm,)
    duration: float


@_frozen
class Lights:
    ambient: Tensor  # ()
    direction: Tensor  # (MAX_LIGHTS, 3)
    color: Tensor  # (MAX_LIGHTS, 3)
    intensity: Tensor  # (MAX_LIGHTS,)
    count: Tensor  # ()


@_frozen
class ModelArrays:
    skeleton: Skeleton
    ik: IKChains
    skinning: Skinning
    geometry: Geometry
    materials: Materials
    atlas: TextureAtlas
    morphs: Morphs
    physics: PhysicsModel


# ---------------------------------------------------------------------------
# Dynamic state
# ---------------------------------------------------------------------------


@_frozen
class TweenState:
    active: Tensor  # (J,) bool
    start_quat: Tensor  # (J, 4)
    target_quat: Tensor  # (J, 4)
    start_time: Tensor  # (J,)
    duration: Tensor  # (J,)


@_frozen
class PhysicsState:
    position: Tensor  # (NB, 3)
    quat: Tensor  # (NB, 4)
    lin_vel: Tensor
    ang_vel: Tensor
    initialized: Tensor  # () bool
    time_accum: Tensor  # ()


@_frozen
class DiagState:
    """Work dropped at a static capacity in the last stepped frame."""

    pair_overflow: Tensor  # () raster (tile, tri) pairs beyond the cap
    contact_overflow: Tensor  # () contacts beyond the top-k


@_frozen
class SceneState:
    time: Tensor  # ()
    local_rot: Tensor  # (J, 4)
    local_trans: Tensor  # (J, 3)
    morph_weights: Tensor  # (Nm,)
    tween: TweenState
    physics: PhysicsState
    playing: Tensor  # () bool
    play_t0: Tensor  # ()
    diag: DiagState


def _quat0(n: int, device) -> Tensor:
    q = torch.zeros((n, 4), device=device)
    q[:, 3] = 1.0
    return q


def init_physics_state(n_bodies: int, device="cuda") -> PhysicsState:
    """Bodies not yet placed: the first step puts them at their bones."""
    def f(*shape):
        return torch.zeros(shape, device=device)

    return PhysicsState(position=f(n_bodies, 3), quat=_quat0(n_bodies, device),
                        lin_vel=f(n_bodies, 3), ang_vel=f(n_bodies, 3),
                        initialized=torch.zeros((), dtype=torch.bool, device=device),
                        time_accum=f())


def init_scene_state(model: ModelArrays) -> SceneState:
    device = model.skeleton.parent.device
    j = model.skeleton.j
    nm = model.morphs.offsets.shape[0]
    nb = model.physics.bone_index.shape[0]

    def f(*shape):
        return torch.zeros(shape, device=device)

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=device)

    return SceneState(
        time=scalar(0.0),
        local_rot=_quat0(j, device),
        local_trans=f(j, 3),
        morph_weights=f(nm),
        tween=TweenState(
            active=torch.zeros(j, dtype=torch.bool, device=device),
            start_quat=_quat0(j, device),
            target_quat=_quat0(j, device),
            start_time=f(j),
            duration=torch.ones(j, device=device),
        ),
        physics=init_physics_state(nb, device),
        playing=scalar(False, torch.bool),
        play_t0=scalar(0.0),
        diag=DiagState(pair_overflow=scalar(0, torch.int64),
                       contact_overflow=scalar(0, torch.int64)),
    )


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
