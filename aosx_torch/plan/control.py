"""Control-mode state machine (mirror of ``aosx/plan/control.py``;
reference: src/aos_state_machine_node.cpp). Modes: 0 follow, 1 precise
approach, 2 semi-precise approach, 3 stop/arrived."""

from __future__ import annotations

import torch

from ..config import AosParams
from ..geom import normalized_angle
from ..ops import sqrt, take_row
from ..types import ControlState, Path


def on_path(state: ControlState, path: Path) -> ControlState:
    """pathCallback (cpp:60-77): adopt the new goal (last pose of /plan)
    only when it differs from the current goal. Leaves may carry leading
    lane axes."""
    has = path.count > 0
    gi = torch.clamp(path.count - 1, min=0)
    new_xy = take_row(path.xy, gi)
    new_yaw = take_row(path.yaw, gi)
    changed = has & (~state.goal_initialized | (new_xy != state.goal_xy).any(dim=-1)
                     | (new_yaw != state.goal_yaw))
    return ControlState(
        mode=state.mode,
        is_path_received=state.is_path_received | changed,
        goal_initialized=state.goal_initialized | changed,
        odom_cnt=state.odom_cnt,
        goal_xy=torch.where(changed[..., None], new_xy, state.goal_xy),
        goal_yaw=torch.where(changed, new_yaw, state.goal_yaw),
    )


def control_tick(state: ControlState, pose_xy, pose_yaw, params: AosParams):
    """baseLinkOdomCallback + updateControlMode (cpp:83-141) for one
    odometry message. Returns (state, publish, mod, goal_xy, goal_yaw); the
    1-in-5 decimation rides odom_cnt, and mod 3 is published before the
    first path. Every leaf may carry leading lane axes (and so may every
    field of params): the arithmetic is elementwise per lane."""
    cnt = state.odom_cnt + 1
    fire = (cnt % params.sm_skipping_hz) == 0
    cnt = torch.where(fire, 0, cnt).to(torch.int32)

    dxy = state.goal_xy - pose_xy
    dist = sqrt(dxy[..., 0] * dxy[..., 0] + dxy[..., 1] * dxy[..., 1])
    yaw_diff = torch.abs(normalized_angle(state.goal_yaw - pose_yaw))

    m = state.mode
    pr = state.is_path_received
    stop1 = (dist < params.sm_precise_dist) & (yaw_diff < params.sm_precise_yaw) & (m == 1) & pr
    stop2 = (dist < params.sm_semi_dist) & (yaw_diff < params.sm_semi_yaw) & (m == 2) & pr
    approach = (dist < params.sm_approach_dist) & (m != 3)
    follow = (m != 2) & (m != 1) & pr

    new_mode = torch.where(stop1 | stop2, 3,
                           torch.where(approach, 2, torch.where(follow, 0, m)))
    new_pr = torch.where(stop1 | stop2, False, pr)

    upd = fire & state.goal_initialized
    mode = torch.where(upd, new_mode, state.mode).to(torch.int32)
    pr_out = torch.where(upd, new_pr, state.is_path_received)
    mod_out = torch.where(state.goal_initialized, mode, 3).to(torch.int32)

    st = ControlState(
        mode=mode,
        is_path_received=pr_out,
        goal_initialized=state.goal_initialized,
        odom_cnt=cnt,
        goal_xy=state.goal_xy,
        goal_yaw=state.goal_yaw,
    )
    return st, fire, mod_out, state.goal_xy, state.goal_yaw
