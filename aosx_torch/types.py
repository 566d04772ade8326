"""Core tensor types, mirroring ``aosx/types.py`` field for field.

Every structure is a fixed-shape padded tensor plus a validity mask or count,
with the same shapes and dtypes as the JAX package, so that
``convert.to_numpy`` of a port value and of a JAX value compare leaf for
leaf. Field annotations name the nested types; ``convert.to_torch`` reads
them to rebuild nested values.

- GridWorld   <- nav_msgs/OccupancyGrid        (values {0,1})
- SeedSet     <- geometry_msgs/PoseArray       (/voronoi_seeds)
- TreeRows    <- /exploration_tree_rows_info pairs
- GvdGraph    <- msg/GvdGraph.msg              (ragged labels densified)
- MissionState / ControlState <- aos_path_gen_node + aos_state_machine_node
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Statics

Tensor = torch.Tensor


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-size point buffer. xyz: [N,3] f32, valid: [N] bool."""

    xyz: Tensor
    valid: Tensor


@dataclasses.dataclass(frozen=True)
class Polygon:
    """Exploration area polygon. pts: [P,2] f32, count: i32 (0 => none)."""

    pts: Tensor
    count: Tensor

    @staticmethod
    def from_array(arr, s: Statics, device) -> "Polygon":
        arr = np.asarray(arr, np.float32)
        n = arr.shape[0]
        pts = np.zeros((s.max_poly, 2), np.float32)
        pts[:n] = arr
        return Polygon(pts=torch.from_numpy(pts).to(device), count=_i32(n, device))

    def bbox(self):
        """(minx, maxx, miny, maxy) of the valid vertices; with leading world
        axes on pts [*B, P, 2] and count [*B], each of shape B."""
        idx = torch.arange(self.pts.shape[-2], device=self.pts.device)
        m = idx < self.count[..., None]
        big = torch.tensor(3.4e38, dtype=torch.float32, device=self.pts.device)
        xs, ys = self.pts[..., 0], self.pts[..., 1]
        minx = torch.where(m, xs, big).min(dim=-1).values
        maxx = torch.where(m, xs, -big).max(dim=-1).values
        miny = torch.where(m, ys, big).min(dim=-1).values
        maxy = torch.where(m, ys, -big).max(dim=-1).values
        return minx, maxx, miny, maxy


@dataclasses.dataclass(frozen=True)
class GridWorld:
    """Occupancy grid. occ: [H,W] uint8 {0,1}; live region is
    [0:h_cells, 0:w_cells]; world = origin + cell * res (cell corner)."""

    occ: Tensor
    origin_x: Tensor
    origin_y: Tensor
    h_cells: Tensor
    w_cells: Tensor


@dataclasses.dataclass(frozen=True)
class SeedSet:
    """Voronoi seeds. xy: [S,2] f32, valid: [S] bool, kind: [S] i8
    (0=virtual base, 1=virtual ray, 2=endpoint ray, 3=row endpoint, 4=real)."""

    xy: Tensor
    valid: Tensor
    kind: Tensor


@dataclasses.dataclass(frozen=True)
class TreeRows:
    """Tree rows; ep1/ep2 follow the GVD node's convention (ep1 = "TOP")."""

    center: Tensor   # [R,2]
    ep1: Tensor      # [R,2]
    ep2: Tensor      # [R,2]
    length: Tensor   # [R]
    valid: Tensor    # [R] bool


def _zero_guards():
    return torch.zeros((), dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class GvdGraph:
    """Padded GvdGraph: nodes [N,2] f32, node_valid [N], node_labels [N] i32
    bitmask (1=TL,2=TR,4=BL,8=BR), label_node [C,4] i32 (-1 if none),
    edges [E,2] i32, edge_valid [E], edge_lengths [E] f32,
    edge_clearances [E] f32, num_nodes, num_edges, guards (aosx_torch.guards)."""

    nodes: Tensor
    node_valid: Tensor
    node_labels: Tensor
    label_node: Tensor
    edges: Tensor
    edge_valid: Tensor
    edge_lengths: Tensor
    edge_clearances: Tensor
    num_nodes: Tensor
    num_edges: Tensor
    guards: Tensor = dataclasses.field(default_factory=_zero_guards)


@dataclasses.dataclass(frozen=True)
class Waypoints:
    """Boustrophedon waypoint tour. xy [W,2], node_idx [W] i32 (-1 =
    off-graph, e.g. origin), count i32."""

    xy: Tensor
    node_idx: Tensor
    count: Tensor


@dataclasses.dataclass(frozen=True)
class Path:
    """Planned path, fixed buffer. xy [P,2], yaw [P], count i32."""

    xy: Tensor
    yaw: Tensor
    count: Tensor


@dataclasses.dataclass(frozen=True)
class MissionState:
    """Mission planner state. status: 0 = Success, 1 = Failed,
    2 = Returning..., 3 = Exploration Complete."""

    target_wp: Tensor
    prev_wp: Tensor
    initial_reached: Tensor
    exploration_completed: Tensor
    waiting_for_docking: Tensor
    status: Tensor
    origin_appended: Tensor

    @staticmethod
    def initial(device) -> "MissionState":
        false = torch.zeros((), dtype=torch.bool, device=device)
        return MissionState(
            target_wp=_i32(-1, device),
            prev_wp=_i32(-1, device),
            initial_reached=false,
            exploration_completed=false,
            waiting_for_docking=false,
            status=_i32(1, device),
            origin_appended=false,
        )


@dataclasses.dataclass(frozen=True)
class ControlState:
    """State-machine node state (mode: 0 follow, 1 precise, 2 semi, 3 stop)."""

    mode: Tensor
    is_path_received: Tensor
    goal_initialized: Tensor
    odom_cnt: Tensor
    goal_xy: Tensor        # [2]
    goal_yaw: Tensor

    @staticmethod
    def initial(device) -> "ControlState":
        false = torch.zeros((), dtype=torch.bool, device=device)
        return ControlState(
            mode=_i32(0, device),
            is_path_received=false,
            goal_initialized=false,
            odom_cnt=_i32(0, device),
            goal_xy=torch.zeros((2,), dtype=torch.float32, device=device),
            goal_yaw=torch.zeros((), dtype=torch.float32, device=device),
        )


STATUS_STRINGS = {0: "Success", 1: "Failed", 2: "Returning...", 3: "Exploration Complete"}
