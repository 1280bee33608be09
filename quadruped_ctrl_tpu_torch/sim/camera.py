"""Head-mounted depth camera + point-cloud synthesis.

The counterpart of `quadruped_ctrl_tpu/sim/camera.py`. The reference runs a
20 Hz thread rendering 80x60 RGB-D from PyBullet and back-projecting depth to
a world point cloud with a Python double loop (walking_simulation.py:246-356,
the loop at :311-328). Here: a vectorized sphere-traced depth render of the
terrain height function — no loops, batched over pixels — with the same
camera geometry: eye on the head, pitched 60 degrees down-forward (the
reference's T1 matrix, walking_simulation.py:263-264), 60-degree FOV.

The traced scene includes the robot when its pose is passed
(`robot=(cfg_robot, q)`): the body as an oriented box (CAD dims from
RobotConfig) and each leg as two capsules (hip->knee, knee->foot) posed by
the analytic FK, as PyBullet's world render sees the robot's own body.
Every image is computed where the pose tensors lie.
"""

from __future__ import annotations

import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.core import rotations as rot
from quadruped_ctrl_tpu_torch.models import leg_kinematics
from quadruped_ctrl_tpu_torch.sim.terrain import (Terrain, base_height_at,
                                                  box_occupancy, height_at)

WIDTH, HEIGHT = 80, 60
FOV_DEG = 60.0
NEAR, FAR = 0.1, 4.0          # the reference discards Z>4 (line 316)
LEG_RADIUS = 0.022            # leg-link capsule radius [m]


def _f32(values, like):
    return _device.constant(values, like.device)


def robot_primitives(cfg_robot, base_p, base_quat, q):
    """World-frame occlusion primitives of the robot itself.

    Returns (r_body (3,3), center (3,), half (3,), seg_a (8,3), seg_b (8,3)):
    the body box (CAD dims) and the 8 leg-link segments (4x hip->knee,
    4x knee->foot) whose capsules approximate the leg meshes PyBullet
    renders. q: (4,3) joint angles [abad, hip, knee] per leg."""
    r = rot.quat_to_rot(base_quat)            # body->world
    half = _f32([cfg_robot.body_length / 2.0,
                 cfg_robot.body_width / 2.0 + cfg_robot.abad_link_length,
                 cfg_robot.body_height / 2.0], base_p)

    l1 = cfg_robot.abad_link_length
    l2 = cfg_robot.hip_link_length
    l4 = cfg_robot.knee_link_y_offset
    side = _f32(cfg_robot.side_signs, q)
    s1, s2 = torch.sin(q[:, 0]), torch.sin(q[:, 1])
    c1, c2 = torch.cos(q[:, 0]), torch.cos(q[:, 1])
    # knee position in the hip frame: the foot FK expressions with the
    # shank (l3) terms dropped (leg_kinematics.leg_fk)
    knee_hip = torch.stack(
        [l2 * s2,
         (l1 + l4) * side * c1 + l2 * c2 * s1,
         (l1 + l4) * side * s1 - l2 * c1 * c2], dim=-1)          # (4,3)
    foot_hip = leg_kinematics.leg_fk(cfg_robot, q)               # (4,3)
    hips = _f32(cfg_robot.hip_locations(), q)                    # (4,3)

    def to_world(p_hip):
        return base_p[None, :] + torch.einsum("ij,fj->fi", r, hips + p_hip)

    hip_w = base_p[None, :] + torch.einsum("ij,fj->fi", r, hips)
    knee_w = to_world(knee_hip)
    foot_w = to_world(foot_hip)
    seg_a = torch.cat([hip_w, knee_w], dim=0)                    # (8,3)
    seg_b = torch.cat([knee_w, foot_w], dim=0)                   # (8,3)
    return r, base_p, half, seg_a, seg_b


def robot_occupancy(prims, pts):
    """Boolean occupancy of the robot primitives at world points pts
    (..., 3): inside the body box OR within LEG_RADIUS of a leg segment."""
    r, center, half, seg_a, seg_b = prims
    pl = torch.einsum("ji,...j->...i", r, pts - center)         # world->body
    in_box = torch.all(pl.abs() <= half, dim=-1)

    ab = seg_b - seg_a                                           # (8,3)
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)   # (8,)
    d = pts[..., None, :] - seg_a                                # (...,8,3)
    t = torch.clamp(torch.sum(d * ab, dim=-1) / denom, 0.0, 1.0)
    closest = d - t[..., None] * ab
    in_leg = torch.any(
        torch.sum(closest * closest, dim=-1) <= LEG_RADIUS**2, dim=-1
    )
    return in_box | in_leg


def camera_pose(base_p, base_quat):
    """(eye, forward, right, down) of the head camera in world frame.

    Mount: 0.25 m forward of the base origin, looking 60 degrees below the
    horizon (the reference's T1: cos30 forward, -sin30... composed with the
    body pose T2; walking_simulation.py:263-271).
    """
    r = rot.quat_to_rot(base_quat)            # body->world
    eye = base_p + r @ _f32([0.25, 0.0, 0.0], base_p)
    half_sqrt3 = torch.sqrt(_f32(3.0, base_p)) / 2.0
    fwd_body = torch.stack([half_sqrt3, torch.zeros_like(half_sqrt3),
                            torch.full_like(half_sqrt3, -0.5)])
    forward = r @ fwd_body
    right = r @ _f32([0.0, -1.0, 0.0], base_p)
    down = torch.linalg.cross(forward, right)   # image +v points below the horizon
    return eye, forward, right, down


def render_depth(terrain: Terrain, base_p, base_quat, n_steps: int = 48,
                 robot=None):
    """(HEIGHT, WIDTH) depth image by sphere-tracing the scene.

    Each ray marches a fixed number of steps; depth is the first crossing of
    the terrain height function OR of the robot's own geometry (when
    `robot=(cfg_robot, q)` is given — PyBullet's camera sees the robot's
    body/legs in-frame, walking_simulation.py:287-299), FAR if none.
    Returns (depth, dirs, eye, is_robot, is_prop).
    """
    eye, forward, right, down = camera_pose(base_p, base_quat)
    aspect = WIDTH / HEIGHT
    tan_half = torch.tan(torch.deg2rad(_f32(FOV_DEG / 2.0, base_p)))

    dev = base_p.device
    u = (torch.arange(WIDTH, dtype=torch.float32, device=dev) + 0.5) / WIDTH * 2.0 - 1.0
    v = (torch.arange(HEIGHT, dtype=torch.float32, device=dev) + 0.5) / HEIGHT * 2.0 - 1.0
    uu, vv = torch.meshgrid(u, v, indexing="xy")                # (H,W)
    dirs = (
        forward[None, None, :]
        + uu[..., None] * tan_half * aspect * right[None, None, :]
        + vv[..., None] * tan_half * down[None, None, :]
    )
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)

    ts = torch.linspace(NEAR, FAR, n_steps, dtype=torch.float32, device=dev)  # (S,)
    pts = eye[None, None, None, :] + ts[:, None, None, None] * dirs[None]  # (S,H,W,3)
    # base terrain kind only: box props are traced as TRUE 3D volumes
    # below (a support-height column would image a floating prop as a wall
    # down to the ground — PyBullet renders the actual collision box)
    ground = base_height_at(terrain, pts[..., 0], pts[..., 1])
    below = pts[..., 2] <= ground
    hit_prop = box_occupancy(terrain, pts)                       # (S,H,W)
    below = below | hit_prop
    if robot is not None:
        cfg_robot, q = robot
        prims = robot_primitives(cfg_robot, base_p, base_quat, q)
        hit_robot = robot_occupancy(prims, pts)                  # (S,H,W)
        below = below | hit_robot
    else:
        hit_robot = torch.zeros_like(below)
    # first step index hitting the scene (S axis), FAR if never
    first = torch.argmax(below.to(torch.uint8), dim=0)           # (H,W)
    any_hit = torch.any(below, dim=0)
    depth = torch.where(any_hit, ts[first], FAR)
    is_robot = torch.gather(hit_robot, 0, first[None])[0] & any_hit
    is_prop = torch.gather(hit_prop, 0, first[None])[0] & any_hit & ~is_robot
    return depth, dirs, eye, is_robot, is_prop


def point_cloud(terrain: Terrain, base_p, base_quat, n_steps: int = 48,
                robot=None):
    """(H*W, 3) world-frame point cloud + validity mask (the reference's
    back-projection loop, vectorized). With `robot=(cfg_robot, q)`,
    self-points from the robot's own body/legs enter the cloud, as they do
    in the reference's /generated_pc."""
    depth, dirs, eye, _, _ = render_depth(terrain, base_p, base_quat,
                                          n_steps, robot=robot)
    pts = eye[None, None, :] + depth[..., None] * dirs
    valid = (depth > NEAR) & (depth < FAR - 1e-3)
    return pts.reshape(-1, 3), valid.reshape(-1)


def render_rgb(terrain: Terrain, base_p, base_quat, n_steps: int = 48,
               light=(0.3, 0.2, 0.9), robot=None):
    """(HEIGHT, WIDTH, 3) uint8 RGB image — the reference renders RGB via
    PyBullet getCameraImage (walking_simulation.py:287-299) and publishes
    mono8 converted from it. Shading of the sphere-traced hit points:
    height-tinted terrain albedo, Lambertian terrain normal
    (finite-difference of the height function) with inverse-distance
    attenuation; sky (no hit) renders light blue; robot self-geometry
    (when `robot=(cfg_robot, q)`) renders as a distance-attenuated dark
    gray body."""
    depth, dirs, eye, is_robot, is_prop = render_depth(
        terrain, base_p, base_quat, n_steps, robot=robot)
    pts = eye[None, None, :] + depth[..., None] * dirs          # (H,W,3)
    eps = 0.05
    # base-kind normals: prop pixels get their own flat tint below, and a
    # box column in the support-height query would put wall-steep gradients
    # on the terrain pixels beside a prop
    hx1 = base_height_at(terrain, pts[..., 0] + eps, pts[..., 1])
    hx0 = base_height_at(terrain, pts[..., 0] - eps, pts[..., 1])
    hy1 = base_height_at(terrain, pts[..., 0], pts[..., 1] + eps)
    hy0 = base_height_at(terrain, pts[..., 0], pts[..., 1] - eps)
    n = torch.stack(
        [-(hx1 - hx0) / (2 * eps), -(hy1 - hy0) / (2 * eps),
         torch.ones_like(hx1)], dim=-1,
    )
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    lv = _f32(light, base_p)
    lv = lv / torch.linalg.vector_norm(lv)
    lambert = torch.clamp(torch.einsum("hwi,i->hw", n, lv), 0.0, 1.0)
    atten = 1.0 / (1.0 + 0.15 * depth * depth)
    hit = depth < FAR - 1e-3
    shade = 0.15 + 0.85 * lambert * atten                       # (H,W)
    # terrain albedo: height-tinted earth tones (greener when higher)
    ground = height_at(terrain, pts[..., 0], pts[..., 1])
    tint = torch.clamp(ground * 4.0 + 0.5, 0.0, 1.0)
    albedo = torch.stack(
        [0.55 + 0.1 * tint, 0.45 + 0.35 * tint, 0.30 + 0.05 * tint], dim=-1
    )
    sky = _f32([0.70, 0.82, 0.95], base_p)
    rgb = torch.where(hit[..., None], shade[..., None] * albedo, sky[None, None, :])
    # box props: crate-tan albedo with distance attenuation (their exact
    # faceted normals aren't worth a per-face trace at 80x60)
    prop_tan = _f32([0.60, 0.48, 0.32], base_p)
    rgb = torch.where(is_prop[..., None], atten[..., None] * prop_tan[None, None, :], rgb)
    robot_gray = _f32([0.25, 0.26, 0.28], base_p)
    rgb = torch.where(is_robot[..., None], atten[..., None] * robot_gray[None, None, :], rgb)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_image(terrain: Terrain, base_p, base_quat, n_steps: int = 48,
                 light=(0.3, 0.2, 0.9), robot=None):
    """(HEIGHT, WIDTH) uint8 mono8 image, converted from the RGB render with
    ITU-R 601 luma weights — the same RGB->'L' conversion PIL applies in the
    reference's /cam0/image_raw path (walking_simulation.py:330-347)."""
    rgb = render_rgb(terrain, base_p, base_quat, n_steps, light,
                     robot=robot).to(torch.float32)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return torch.clamp(luma, 0.0, 255.0).to(torch.uint8)
