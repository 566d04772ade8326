"""A hand-made tour and plan table for tests that run the reference without
the program: the initial straight leg, then legs to each waypoint along a
straight line."""


def plain_tables(worlds: int, W: int = 12, Q: int = 64):
    import torch

    R = W + 5
    wp = torch.zeros(worlds, W, 2)
    wp[:, :3] = torch.tensor([[10.0, 2.0], [10.0, 5.0], [4.0, 5.0]])
    plan = torch.zeros(worlds, R, Q, 2)
    count = torch.zeros(worlds, R, dtype=torch.int32)
    line = torch.linspace(0, 1, 20)[:, None]
    legs = [((0.0, 0.0), (8.0, 0.0)), ((8.0, 0.0), (10.0, 2.0)), ((10.0, 2.0), (10.0, 5.0)),
            ((10.0, 5.0), (4.0, 5.0))]
    for r, (a, b) in enumerate(legs):
        a, b = torch.tensor(a), torch.tensor(b)
        plan[:, r, :20] = a + line * (b - a)
        count[:, r] = 20
    return {"wp_xy": wp, "wp_count": torch.full((worlds,), 3, dtype=torch.int32),
            "plan_xy": plan, "plan_count": count, "goal_xy": plan[:, :, 19].clone(),
            "goal_yaw": torch.zeros(worlds, R), "success": count > 0,
            "nonfinite": torch.zeros(worlds, R, dtype=torch.int32),
            "guards": torch.zeros(worlds, dtype=torch.int32)}
