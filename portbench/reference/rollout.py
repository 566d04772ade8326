"""The cached Monte-Carlo rollout, written from the semantics of the robot's
nodes (the reference's ``aos_state_machine_node.cpp`` and
``aos_path_gen_node.cpp``, as their parameters name them) and of the
stand-in robot, in plain PyTorch, every float in one dtype.

It starts from a world's tour and plan table: the waypoints, and for each
mission configuration (row 0: the initial straight leg; row 1 + t: the leg
to waypoint t; row W + 1: the return to the origin; row W + 2: the return
with prev == target; row W + 3: no target; row W + 4: the empty initial
plan) the linearized plan, its goal pose, whether the planner succeeded and
how many non-finite numbers it held. A tick of a lane:

1. the controller adopts the published plan's last pose as its goal when
   it changed; every ``sm_skipping_hz``-th odometry message updates its
   mode (follow 0, precise 1, semi 2, stop 3) from the goal's distance and
   yaw; before the first goal it publishes 3;
2. the mission advances to the next waypoint when the robot waits docked
   and the controller stopped, appends the origin (unless the last waypoint
   lies within 0.2 m of it) after the last one and then returns there; it
   marks the initial waypoint reached within ``initial_arrive_dist``, the
   exploration complete at the origin (within 1 m of a target within 0.1 m
   of it), and docks within ``docking_radius`` of the target. Unless the
   robot waits docked, the plan of the mission's configuration is published
   when its planner succeeded, and the last published one stays otherwise;
3. the robot moves ``v_dt`` toward the plan point ten past the nearest one
   at or after its last (in mode 0), or toward the goal (modes 1 and 2),
   and turns at most ``yaw_rate`` toward its heading (or, within 0.3 m, to
   the goal's yaw); mode 3 freezes it.

A rollout is recorded at the first boundary of ``chunk_steps`` ticks at
which it completed or spent ``steps_budget``: completed, the first tick at
which it was, the status of the last tick, the travel summed over the
ticks, the distance to the origin, the tour's length, the guards and the
feasibility. With ``flagged_fails``, a flagged rollout (any guard bit)
counts as failed: not completed, status 1."""

from __future__ import annotations

import math


def _row(arr, idx):
    """arr[g, idx[g]] for every lane g."""
    import torch

    return arr[torch.arange(arr.shape[0], device=arr.device), idx]


def _norm(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]).sqrt()


def append_origin(wp_xy, wp_count):
    """The tour with the origin appended unless its last waypoint lies
    within 0.2 m of it (and the buffer's last slot reused when full)."""
    import torch

    W = wp_xy.shape[1]
    last = _row(wp_xy, (wp_count - 1).clamp(min=0))
    near = (wp_count > 0) & (_norm(last) <= 0.2)
    slot = wp_count.clamp(max=W - 1)
    xy = wp_xy.clone()
    put = ~near
    xy[torch.arange(len(slot), device=xy.device)[put], slot[put]] = 0.0
    return xy, torch.where(near, wp_count, (wp_count + 1).clamp(max=W))


def feasibility(tab: dict, p: dict):
    """1 where the tour can complete as planned, else 0: the initial leg's
    goal within ``initial_arrive_dist`` of the initial waypoint, a tour,
    and every leg's plan found and passing within ``docking_radius`` of its
    target (the origin for the return rows)."""
    import torch

    plan_xy, count = tab["plan_xy"], tab["plan_count"]
    G, R, Q, _ = plan_xy.shape
    W = R - 5
    wp_xy, wp_count = tab["wp_xy"], tab["wp_count"]
    xy2, c2 = append_origin(wp_xy, wp_count)
    rows = torch.arange(R, device=plan_xy.device)
    tgt = wp_xy[:, (rows - 1).clamp(0, W - 1)]
    origin = _row(xy2, (c2 - 1).clamp(0, W - 1))
    back = (rows == W + 1) | (rows == W + 2)
    tgt = torch.where(back[None, :, None], origin[:, None], tgt)
    d = _norm(plan_xy - tgt[:, :, None])
    live_pt = torch.arange(Q, device=d.device) < count[..., None]
    mind = torch.where(live_pt, d, torch.full_like(d, float("inf"))).min(-1).values
    dock = tab["success"] & (count > 0) & (mind <= p["docking_radius"])
    leg = (rows >= 1)[None] & (rows[None] <= wp_count[:, None])
    init = torch.tensor(p["initial_waypoint"], dtype=plan_xy.dtype, device=plan_xy.device)
    row0 = _norm(tab["goal_xy"][:, 0] - init) <= p["initial_arrive_dist"]
    return (row0 & torch.where(leg, dock, True).all(-1) & (wp_count > 0)).to(torch.int64)


def simulate(tab: dict, p: dict, budget: int, chunk: int, dtype, device) -> list[dict]:
    """Run every lane of ``tab`` (each a world's tour and plan table, as
    above) from the start until recorded; returns a record per lane."""
    import torch

    tab = {k: (v.to(device=device, dtype=dtype) if v.is_floating_point() else v.to(device))
           for k, v in tab.items()}
    plan_xy, plan_count = tab["plan_xy"], tab["plan_count"].long()
    goal_xy, goal_yaw = tab["goal_xy"], tab["goal_yaw"]
    success, nonfin = tab["success"].bool(), tab["nonfinite"].long()
    G, R, Q, _ = plan_xy.shape
    W = R - 5
    f = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    zero_f, false = torch.zeros(G, **f), torch.zeros(G, dtype=torch.bool, device=device)
    two_pi = torch.tensor(2 * math.pi, **f)
    init_wp = torch.tensor(p["initial_waypoint"], **f)
    v_dt, rate = torch.tensor(p["v_dt"], **f), torch.tensor(p["yaw_rate"], **f)

    # the robot, the mission, the controller
    xy, yaw, follow = torch.zeros(G, 2, **f), zero_f.clone(), torch.zeros(G, **i64)
    wp_xy, wp_count = tab["wp_xy"].clone(), tab["wp_count"].long().clone()
    target, prev = torch.full((G,), -1, **i64), torch.full((G,), -1, **i64)
    reached, done, waiting, appended = false.clone(), false.clone(), false.clone(), false.clone()
    status = torch.ones(G, **i64)
    mode, received, has_goal = torch.zeros(G, **i64), false.clone(), false.clone()
    odom = torch.zeros(G, **i64)
    goal, gyaw = torch.zeros(G, 2, **f), zero_f.clone()
    adopted, last_mod = torch.full((G,), W + 4, **i64), torch.full((G,), 3, **i64)
    # the record's accumulators
    first_done = torch.full((G,), budget, **i64)
    travel, last_xy = zero_f.clone(), torch.zeros(G, 2, **f)
    last_status, guards = torch.zeros(G, **i64), tab["guards"].long().clone()
    records: list = [None] * G
    lanes = torch.arange(G, device=device)
    qi = torch.arange(Q, device=device)

    for tick in range(budget):
        # 1. the controller: the published plan's goal, then its mode
        has = _row(plan_count, adopted) > 0
        new_xy, new_yaw = _row(goal_xy, adopted), _row(goal_yaw, adopted)
        changed = has & (~has_goal | (new_xy != goal).any(-1) | (new_yaw != gyaw))
        received, has_goal = received | changed, has_goal | changed
        goal = torch.where(changed[:, None], new_xy, goal)
        gyaw = torch.where(changed, new_yaw, gyaw)
        odom = odom + 1
        fire = odom % int(p["sm_skipping_hz"]) == 0
        odom = torch.where(fire, 0, odom)
        dist = _norm(goal - xy)
        dyaw = gyaw - yaw
        dyaw = torch.where(dyaw > math.pi, dyaw - two_pi, dyaw)
        dyaw = torch.where(dyaw < -math.pi, dyaw + two_pi, dyaw).abs()
        stop = (((dist < p["sm_precise_dist"]) & (dyaw < p["sm_precise_yaw"]) & (mode == 1))
                | ((dist < p["sm_semi_dist"]) & (dyaw < p["sm_semi_yaw"]) & (mode == 2))) \
            & received
        approach = (dist < p["sm_approach_dist"]) & (mode != 3)
        follows = (mode != 2) & (mode != 1) & received
        new_mode = torch.where(stop, 3, torch.where(approach, 2, torch.where(follows, 0, mode)))
        upd = fire & has_goal
        mode = torch.where(upd, new_mode, mode)
        received = torch.where(upd, received & ~stop, received)
        mod = torch.where(has_goal, mode, 3)
        mod = torch.where(fire | ~has_goal, mod, last_mod)
        last_mod = mod

        # 2. the mission
        advance = (mod == 3) & waiting
        at_last = target >= wp_count - 1
        completing = advance & at_last & ~done
        xy2, c2 = append_origin(wp_xy, wp_count)
        wp_xy = torch.where(completing[:, None, None], xy2, wp_xy)
        wp_count = torch.where(completing, c2, wp_count)
        prev = torch.where(advance, target, prev)
        target = torch.where(advance, torch.where(advance & at_last, wp_count - 1, target + 1),
                             target)
        waiting = waiting & ~advance
        done = done | completing
        status = torch.where(completing, 2, status)
        appended = appended | completing
        reach = ~reached & (_norm(xy - init_wp) <= p["initial_arrive_dist"])
        target = torch.where(reach & (wp_count > 0), 0, target)
        prev = torch.where(reach, -1, prev)
        reached = reached | reach
        tvalid = (target >= 0) & (target < wp_count)
        tgt = _row(wp_xy, target.clamp(0, W - 1))
        d_t = _norm(xy - tgt)
        home = done & tvalid & (tgt[:, 0].abs() < 0.1) & (tgt[:, 1].abs() < 0.1) & (d_t <= 1.0)
        status = torch.where(home, 3, status)
        waiting = waiting | (reached & tvalid & (d_t <= p["docking_radius"]) & ~waiting)
        replan = ~waiting | advance
        row = torch.where(~reached, 0, torch.where(
            target < 0, W + 3, torch.where(~appended, 1 + target,
                                           torch.where(prev == target, W + 2, W + 1))))
        ok = _row(success, row)
        use = replan & ok
        follow = torch.where(use & (row != adopted), 0, follow)
        adopted = torch.where(use, row, adopted)
        status = torch.where((status == 3) | (status == 2), status, torch.where(ok, 0, 1))

        # 3. the robot
        n = _row(plan_count, adopted)
        pts = plan_xy[lanes, adopted]
        d = _norm(pts - xy[:, None])
        live = qi[None] < n[:, None]
        window = live & (qi[None] >= follow[:, None])
        inf = torch.full_like(d, float("inf"))
        near_w = torch.where(window, d, inf).argmin(-1)
        near_g = torch.where(live, d, inf).argmin(-1)
        ci = torch.where(window.any(-1), near_w, near_g)
        ahead = _row(pts, torch.minimum(ci + 10, (n - 1).clamp(min=0)))
        aim = torch.where((mod == 0)[:, None], ahead, goal)
        delta = aim - xy
        dd = _norm(delta)
        moved = xy + delta / dd.clamp(min=1e-6)[:, None] * torch.minimum(v_dt, dd)[:, None]
        moved = torch.where((dd > 1e-6)[:, None], moved, xy)
        heading = torch.atan2(delta[:, 1], delta[:, 0])
        turn_to = torch.where(((mod == 1) | (mod == 2) | (dd <= 1e-6)) & (dd < 0.3), gyaw,
                              heading)
        e = turn_to - yaw
        e = torch.atan2(torch.sin(e), torch.cos(e))
        new_yaw = yaw + torch.minimum(torch.maximum(e, -rate), rate)
        new_yaw = new_yaw - two_pi * torch.round(new_yaw / two_pi)
        xy = torch.where((mod == 3)[:, None], xy, moved)
        yaw = torch.where(mod == 3, yaw, new_yaw)
        follow = ci

        # the tick's record
        bad = (~torch.isfinite(xy)).sum(-1) + _row(nonfin, adopted) \
            + (~torch.isfinite(goal)).sum(-1)
        guards = guards | torch.where(bad > 0, p["guard_nonfinite"], 0) \
            | torch.where(n >= Q, p["guard_plan_cap"], 0)
        first_done = torch.where(done, torch.minimum(first_done, torch.tensor(tick, **i64)),
                                 first_done)
        if tick > 0:
            travel = travel + _norm(xy - last_xy)
        last_xy, last_status = xy, status

        age = tick + 1
        if age % chunk == 0:
            due = done | (age >= budget)
            for g in torch.nonzero(due).flatten().tolist():
                if records[g] is None:
                    flagged = bool(p["flagged_fails"]) and int(guards[g]) != 0
                    records[g] = {
                        "completed": bool(done[g]) and not flagged,
                        "steps_to_complete": int(first_done[g]),
                        "final_status": 1 if flagged else int(last_status[g]),
                        "travel_distance": float(travel[g]),
                        "final_dist_to_origin": float(_norm(xy[g])),
                        "waypoints": int(wp_count[g]),
                        "guards": int(guards[g]),
                    }
            if all(r is not None for r in records):
                break
    return records
