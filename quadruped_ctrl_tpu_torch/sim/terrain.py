"""Terrain library for the batched scenario engine.

The counterpart of `quadruped_ctrl_tpu/sim/terrain.py`. The reference builds
five PyBullet terrains (plane, random1 procedural heightfield, random2
heightmap file, stairs, racetrack — scripts/walking_simulation.py:93-159).
Here terrain is a pure height function h(x, y) parameterized by a small
tree, so thousands of scenarios with different terrains batch under vmap.
The heightfield grid size is free; terrains batched together share one grid
(use `grid=` on the constructors).

Constructors that make a terrain from nothing take `device=None` (cuda:0
unless named); `Terrain.random` draws from a `torch.Generator` where the JAX
package takes a key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quadruped_ctrl_tpu_torch import device as _device
from quadruped_ctrl_tpu_torch.core.types import Tree

TERRAIN_PLANE = 0
TERRAIN_RANDOM = 1      # procedural heightfield (reference "random1")
TERRAIN_STAIRS = 2      # box steps (reference "stairs")
TERRAIN_SLOPE = 3
TERRAIN_HEIGHTMAP = 4   # heightmap array/file (reference "random2")

DEFAULT_GRID = (64, 64)
MAX_BOXES = 4           # static prop-slot count (unused slots are inert)


def _scalar(v, dtype, dev):
    return torch.full((), v, dtype=dtype, device=dev)


@dataclasses.dataclass(frozen=True)
class Terrain(Tree):
    """Batched terrain parameters; `kind` selects the height function.

    Box props (`box_*`) are static obstacles layered over any base kind (the
    reference's racetrack props, worlds/racetrack_day.world:32-45): each is a
    yaw-rotated box whose walkable top face is the point-foot support height.
    """

    kind: torch.Tensor          # () int32
    heightfield: torch.Tensor   # (H, W), scale meters/cell
    cell_size: torch.Tensor     # ()
    stair_depth: torch.Tensor   # () stairs: step depth/height along +x from x0
    stair_height: torch.Tensor  # ()
    stair_x0: torch.Tensor      # ()
    box_center: torch.Tensor    # (MAX_BOXES, 3); half_z == 0 marks an empty slot
    box_half: torch.Tensor      # (MAX_BOXES, 3)
    box_yaw: torch.Tensor       # (MAX_BOXES,)
    # slope: grade in x. It stays the LAST field: the `slope` staticmethod
    # below shares its name, so dataclasses takes the method object as this
    # field's default, and a field declared after it would be a
    # non-default-after-default TypeError.
    slope: torch.Tensor         # ()

    @staticmethod
    def plane(grid=DEFAULT_GRID, device=None):
        dev = _device.resolve(device)
        f32 = torch.float32
        return Terrain(
            kind=_scalar(TERRAIN_PLANE, torch.int32, dev),
            heightfield=torch.zeros(tuple(grid), dtype=f32, device=dev),
            cell_size=_scalar(0.1, f32, dev),
            stair_depth=_scalar(0.2, f32, dev),
            stair_height=_scalar(0.02, f32, dev),
            stair_x0=_scalar(1.0, f32, dev),
            slope=_scalar(0.0, f32, dev),
            box_center=torch.zeros((MAX_BOXES, 3), dtype=f32, device=dev),
            box_half=torch.zeros((MAX_BOXES, 3), dtype=f32, device=dev),
            box_yaw=torch.zeros((MAX_BOXES,), dtype=f32, device=dev),
        )

    def with_boxes(self, centers, halves, yaws=None):
        """Place up to MAX_BOXES solid box props on this terrain.

        centers/halves: (k, 3) world center and half-extents; yaws: (k,)
        rotation about z (default 0). Slots beyond k stay inert."""
        dev = self.box_center.device
        centers = torch.as_tensor(np.asarray(centers, np.float32).reshape(-1, 3), device=dev)
        halves = torch.as_tensor(np.asarray(halves, np.float32).reshape(-1, 3), device=dev)
        k = centers.shape[0]
        if k > MAX_BOXES or halves.shape[0] != k:
            raise ValueError(f"with_boxes: {k} centers, {halves.shape[0]} halves; "
                             f"at most {MAX_BOXES} boxes")
        yaws = (torch.zeros((k,), dtype=torch.float32, device=dev) if yaws is None
                else torch.as_tensor(np.asarray(yaws, np.float32).reshape(-1), device=dev))
        return self.replace(
            box_center=torch.cat([centers, self.box_center[k:]]),
            box_half=torch.cat([halves, self.box_half[k:]]),
            box_yaw=torch.cat([yaws, self.box_yaw[k:]]),
        )

    @staticmethod
    def random(generator: torch.Generator, amplitude=0.03, cell_size=0.1,
               grid=DEFAULT_GRID, device=None):
        """Procedural rough ground (reference random1: +-0.06 m cells,
        walking_simulation.py:101-119; amplitude halved by default for the
        point-foot SRB model), drawn from `generator`."""
        base = Terrain.plane(grid, device=device)
        hf = torch.rand(tuple(grid), generator=generator, dtype=torch.float32,
                        device=generator.device) * amplitude
        return base.replace(
            kind=_scalar(TERRAIN_RANDOM, torch.int32, base.kind.device),
            heightfield=hf.to(base.kind.device),
            cell_size=_scalar(cell_size, torch.float32, base.kind.device),
        )

    @staticmethod
    def from_array(arr, cell_size=0.5, z_scale=1.0, grid=None, device=None):
        """Terrain from an arbitrary heightmap array — the reference "random2"
        (walking_simulation.py:120-130). The array is nearest-resampled to
        `grid` (default: its own shape); heights are shifted so the
        grid-center cell sits at z=0."""
        hf = np.asarray(arr, dtype=np.float32) * float(z_scale)
        if grid is not None and tuple(hf.shape) != tuple(grid):
            # cell size scales with the resampling so world extent is kept
            cell_size = cell_size * hf.shape[0] / grid[0]
            ix = (np.arange(grid[0]) * hf.shape[0] / grid[0]).astype(int)
            iy = (np.arange(grid[1]) * hf.shape[1] / grid[1]).astype(int)
            hf = hf[np.ix_(ix, iy)]
        hf = hf - hf[hf.shape[0] // 2, hf.shape[1] // 2]
        base = Terrain.plane(hf.shape, device=device)
        dev = base.kind.device
        return base.replace(
            kind=_scalar(TERRAIN_HEIGHTMAP, torch.int32, dev),
            heightfield=torch.as_tensor(hf, device=dev),
            cell_size=_scalar(cell_size, torch.float32, dev),
        )

    @staticmethod
    def from_file(path: str, cell_size=0.5, z_scale=0.5, grid=None, device=None):
        """Load a heightmap file: .txt (the reference random2's format),
        .npy, or an image (grayscale/255 -> height). Defaults mirror the
        reference's meshScale [.5,.5,.5] (walking_simulation.py:122-125)."""
        low = path.lower()
        if low.endswith(".txt"):
            arr = np.loadtxt(path)
        elif low.endswith(".npy"):
            arr = np.load(path)
        else:
            from PIL import Image

            arr = np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0
        return Terrain.from_array(arr, cell_size=cell_size, z_scale=z_scale, grid=grid,
                                  device=device)

    @staticmethod
    def stairs(depth=0.2, height=0.02, x0=1.0, grid=DEFAULT_GRID, device=None):
        base = Terrain.plane(grid, device=device)
        dev = base.kind.device
        return base.replace(
            kind=_scalar(TERRAIN_STAIRS, torch.int32, dev),
            stair_depth=_scalar(depth, torch.float32, dev),
            stair_height=_scalar(height, torch.float32, dev),
            stair_x0=_scalar(x0, torch.float32, dev),
        )

    @staticmethod
    def slope(grade=0.1, grid=DEFAULT_GRID, device=None):
        base = Terrain.plane(grid, device=device)
        dev = base.kind.device
        return base.replace(
            kind=_scalar(TERRAIN_SLOPE, torch.int32, dev),
            slope=_scalar(grade, torch.float32, dev),
        )


def box_support(terrain: Terrain, x, y):
    """Support height contributed by box props at world (x, y): the top
    face of any box whose (yaw-rotated) footprint contains the point,
    -inf elsewhere. Broadcasts like height_at."""
    dx = x[..., None] - terrain.box_center[:, 0]
    dy = y[..., None] - terrain.box_center[:, 1]
    c, s = torch.cos(terrain.box_yaw), torch.sin(terrain.box_yaw)
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    inside = (
        (lx.abs() <= terrain.box_half[:, 0])
        & (ly.abs() <= terrain.box_half[:, 1])
        & (terrain.box_half[:, 2] > 0.0)
    )
    top = terrain.box_center[:, 2] + terrain.box_half[:, 2]
    return torch.amax(torch.where(inside, top, -torch.inf), dim=-1)


def box_occupancy(terrain: Terrain, pts):
    """Boolean: world points pts (..., 3) inside any box prop's volume
    (yaw-rotated, z-bounded)."""
    d = pts[..., None, :] - terrain.box_center                 # (...,K,3)
    c, s = torch.cos(terrain.box_yaw), torch.sin(terrain.box_yaw)
    lx = c * d[..., 0] + s * d[..., 1]
    ly = -s * d[..., 0] + c * d[..., 1]
    inside = (
        (lx.abs() <= terrain.box_half[:, 0])
        & (ly.abs() <= terrain.box_half[:, 1])
        & (d[..., 2].abs() <= terrain.box_half[:, 2])
        & (terrain.box_half[:, 2] > 0.0)
    )
    return inside.any(dim=-1)


def base_height_at(terrain: Terrain, x, y):
    """Height of the base terrain kind alone (no box props); broadcasts
    over trailing dims."""
    hw = terrain.heightfield.shape
    gx = torch.clamp(x / terrain.cell_size + hw[0] / 2, 0, hw[0] - 1).to(torch.int32)
    gy = torch.clamp(y / terrain.cell_size + hw[1] / 2, 0, hw[1] - 1).to(torch.int32)
    h_field = terrain.heightfield[gx.long(), gy.long()]
    h_stairs = torch.clamp(
        torch.floor((x - terrain.stair_x0) / terrain.stair_depth) + 1, 0, 4
    ) * terrain.stair_height
    h_slope = terrain.slope * x
    zero = torch.zeros_like(x)
    kind = terrain.kind
    return torch.where(
        (kind == TERRAIN_RANDOM) | (kind == TERRAIN_HEIGHTMAP), h_field,
        torch.where(kind == TERRAIN_STAIRS, h_stairs,
                    torch.where(kind == TERRAIN_SLOPE, h_slope, zero)))


def height_at(terrain: Terrain, x, y):
    """Terrain support height at world (x, y) — the contact query;
    broadcasts over trailing dims. Box props stack over the base kind via
    max: a foot on a prop footprint contacts the prop top."""
    return torch.maximum(base_height_at(terrain, x, y), box_support(terrain, x, y))
