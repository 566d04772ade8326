"""Sustained Monte-Carlo rollouts: the traffic of a planner evaluation over
a population of orchards.

A copy of the queue of ``aosx_torch.parallel.batch.sustained_rollouts``
(one device), run for a window of time instead of a number of rollouts:
``lanes`` resident lanes, each running one rollout of the population
(rollout id i is the orchard of ``population_keys(seed)[i]``); at every
chunk boundary (``chunk_steps`` control ticks of every lane in one call)
the lanes that completed or ran out of ``steps_budget`` are recorded, and
retired lanes are refilled ``refill`` at a time with freshly built worlds
(``rollout_begin_group``: orchard, world, plan cache and classification of
the group in one call).

The traffic file: ``lanes``, ``refill``, ``population`` (keys drawn),
``trace_cycles`` (chunk boundaries in the traced slice; more until the
slice holds a refill), ``compare_per_block`` and ``compare_groups``.

The compared rollouts span the batch: in every block of ``refill`` lanes,
``compare_per_block`` lanes drawn from the seed, each with the rollout it
holds when the window opens (begun in the set-up, stepped and recorded in
the window); and every rollout of the first ``compare_groups`` refill
groups begun in the window. Their records, and the tour, plan table, row
count and feasibility their world builds gave, go to the check."""

from __future__ import annotations

import time

import numpy as np

from .common import orchard_spec, params, population_keys, statics

RECORD_FIELDS = ("completed", "steps_to_complete", "final_status", "travel_distance",
                 "final_dist_to_origin", "waypoints", "guards", "feasible")


class Driver:
    def __init__(self, ctx):
        import torch
        from aosx_torch import config as pconfig
        from aosx_torch.orchards import OrchardSpec

        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.dev = ctx.device
        self.s = statics(pconfig, cfg)
        self.spec = orchard_spec(OrchardSpec, cfg)
        self.params = params(pconfig, cfg, self.dev)
        self.lanes, self.refill = int(tr["lanes"]), int(tr["refill"])
        self.budget, self.chunk_steps = int(cfg["steps_budget"]), int(cfg["chunk_steps"])
        self.ror = cfg["ror_method"]
        if self.lanes % self.refill or self.budget % self.chunk_steps:
            raise ValueError("lanes must divide by refill and steps_budget by chunk_steps")
        self.population = int(tr["population"])
        self.keys = population_keys(ctx.seed, self.population)
        rng = np.random.default_rng(ctx.seed)
        self.per_block = int(tr["compare_per_block"])
        self.n_groups = int(tr["compare_groups"])
        # in each block, twice the compared lanes as candidates, in the
        # seed's order: the first whose rollout runs at the window's start
        self.candidates = [b + rng.permutation(self.refill)[:2 * self.per_block]
                           for b in range(0, self.lanes, self.refill)]
        self.watch = set(int(x) for c in self.candidates for x in c)
        self.begun = {}          # candidate lane -> (rollout id, its begin outputs)
        self.compared = {}       # rollout id -> its begin outputs
        self.compared_groups = []  # (ids, begin outputs) of refills in the window
        self.first_compared = None
        self.torch = torch

        self.recorded = np.zeros(self.lanes, bool)
        self.ages = np.zeros(self.lanes, np.int32)
        self.rid = np.arange(self.lanes, dtype=np.int64)
        self.next_id = self.lanes
        self.records: dict[int, dict] = {}
        self.n_recorded = self.n_flagged = 0
        self.chunks = self.begins = 0
        self.refills_since_window = 0
        self.blocks = None

    # -- the program's calls ------------------------------------------------

    def _begin(self, ids):
        from aosx_torch.parallel import batch

        return batch.rollout_begin_group(self.keys[np.asarray(ids)], self.spec, self.params,
                                         self.s, self.budget, self.ror, self.dev)

    def _keep(self, ids, lanes, new):
        """Keep the begin outputs of the rollouts that may be compared."""
        from aosx_torch import tree

        if self.ctx.spans.phase != "setup":
            # a whole group: sliced after the window (``new`` is never
            # written in place)
            self.compared_groups.append((np.asarray(ids), new))
            return
        for j, (rid, ln) in enumerate(zip(ids, lanes)):
            if int(ln) in self.watch:
                self.begun[int(ln)] = (int(rid), tree.tree_map(lambda x: x[j].clone(), new))

    def _chunk(self):
        from aosx_torch import tree
        from aosx_torch.parallel import batch

        lite, cache, st, acc = self.blocks
        fault = self.ctx.fault
        if fault == "step_unchanged":
            return st, acc
        off = self.torch.from_numpy(self.ages).to(self.dev)
        st2, acc2 = batch.rollout_chunk_cached(lite, cache, st, acc, self.params, self.s,
                                               self.chunk_steps, off)
        if fault == "half_lanes":
            rest = self.torch.arange(self.lanes // 2, self.lanes, device=self.dev)
            st2, acc2 = tree.scatter((st2, acc2), rest, tree.lane((st, acc), rest))
        return st2, acc2

    def _sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    # -- the queue ------------------------------------------------------------

    def _cycle(self):
        """One chunk boundary: the chunk, its records, the refills."""
        from aosx_torch import tree
        from aosx_torch.convert import to_numpy
        from aosx_torch.parallel import batch

        spans = self.ctx.spans
        with spans.span("chunk"):
            st, acc = self._chunk()
            comp = st.mission.exploration_completed.cpu().numpy()
        self.blocks = (self.blocks[0], self.blocks[1], st, acc)
        self.chunks += 1
        self.ages += self.chunk_steps
        finished = (comp | (self.ages >= self.budget)) & ~self.recorded
        if finished.any():
            with spans.span("record"):
                summ = to_numpy(batch.rollout_finish(st, acc, self.s))
            for ln in np.nonzero(finished)[0]:
                rec = {k: summ[k][ln].item() for k in RECORD_FIELDS}
                if self.ctx.fault == "answer_altered" and self.rid[ln] == self.first_compared:
                    rec["travel_distance"] += 1.0
                self.records[int(self.rid[ln])] = rec
                self.recorded[ln] = True
                self.n_recorded += 1
                self.n_flagged += rec["guards"] != 0
        while self.recorded.sum() >= self.refill and self.next_id + self.refill <= self.population:
            idx = np.nonzero(self.recorded)[0][:self.refill]
            ids = np.arange(self.next_id, self.next_id + self.refill)
            with spans.span("begin"):
                new = self._begin(ids)
                local = self.torch.from_numpy(idx).to(self.dev)
                self.blocks = tree.scatter(self.blocks, local, new)
                self._sync()
            self.begins += 1
            if spans.phase == "setup" or self.refills_since_window < self.n_groups:
                self._keep(ids, idx, new)
            if spans.phase != "setup":
                self.refills_since_window += 1
            self.ages[idx] = 0
            self.recorded[idx] = False
            self.rid[idx] = ids
            self.next_id += self.refill

    def setup(self):
        """The initial fill (lanes / refill groups), then one chunk boundary,
        which warms the chunk, the records and a refill."""
        from aosx_torch import tree

        with self.torch.no_grad(), self.ctx.spans.span("fill"):
            groups = []
            for j in range(0, self.lanes, self.refill):
                ids = np.arange(j, j + self.refill)
                groups.append(self._begin(ids))
                self._keep(ids, ids, groups[-1])
            self.blocks = tree.cat(groups)
            self._sync()
        del groups
        self.begins += self.lanes // self.refill
        with self.torch.no_grad():
            self._cycle()

    def window(self, seconds: float) -> dict:
        """Chunk boundaries until ``seconds`` have passed. A rate over all
        the window's work and time: rollouts recorded / window seconds."""
        for cand in self.candidates:
            live = [int(ln) for ln in cand
                    if not self.recorded[ln] and int(ln) in self.begun][:self.per_block]
            for ln in live:
                rid, begun = self.begun[ln]
                self.compared[rid] = begun
        self.first_compared = min(self.compared)
        self.begun = {}
        rec0, flag0, ch0, be0 = self.n_recorded, self.n_flagged, self.chunks, self.begins
        t0 = time.perf_counter()
        with self.torch.no_grad():
            while time.perf_counter() - t0 < seconds:
                self._cycle()
        elapsed = time.perf_counter() - t0
        n = self.n_recorded - rec0
        c = self.ctx.counters
        c.update(window_chunks=self.chunks - ch0, window_begins=self.begins - be0,
                 lanes=self.lanes, refill=self.refill, chunk_steps=self.chunk_steps,
                 grid=(self.s.grid_h, self.s.grid_w), seeds=self.s.max_seeds)
        return {"rollouts_per_s": n / elapsed, "attempted": n, "failed": self.n_flagged - flag0,
                "window_s": elapsed, "chunk_calls": self.chunks - ch0,
                "begin_calls": self.begins - be0}

    def traced(self):
        """A fixed slice of the same traffic under the profiler."""
        from aosx_torch.gvd import jfa_pass_cuda
        from aosx_torch.perceive import ror_cuda, skeleton_cuda

        kernels = {"k1": jfa_pass_cuda.jfa_flood, "k2": skeleton_cuda.zhang_suen_fixpoint,
                   "k3": ror_cuda.ror_counts}
        before = {k: f.launches for k, f in kernels.items()}
        ch0, be0 = self.chunks, self.begins
        # the slice's chunk boundaries, and at least one refill in them
        with self.torch.no_grad():
            for i in range(64):
                if i >= int(self.ctx.traffic["trace_cycles"]) and self.begins > be0:
                    break
                self._cycle()
        self.ctx.counters.update(
            traced_chunks=self.chunks - ch0, traced_begins=self.begins - be0,
            traced_launches={k: f.launches - before[k] for k, f in kernels.items()})

    def collect(self) -> dict:
        """The compared rollouts' records and begin outputs, on the host.
        The queue runs on past the window until the compared refill groups
        have begun and every compared rollout is recorded."""
        from aosx_torch import tree

        with self.torch.no_grad():
            for _ in range(100000):
                pending = list(self.compared) + [int(i) for g, _ in self.compared_groups
                                                 for i in g]
                if (self.refills_since_window >= self.n_groups
                        and all(i in self.records for i in pending)):
                    break
                if self.next_id + self.refill > self.population:
                    raise RuntimeError("the population ran out before the compared groups began")
                self._cycle()
        for gids, new in self.compared_groups:
            for j, rid in enumerate(gids):
                self.compared[int(rid)] = tree.lane(new, j)
        ids = sorted(self.compared)
        lite, cache, st, acc = tree.stack([self.compared[i] for i in ids])
        cpu = lambda x: x.detach().cpu()  # noqa: E731
        return {"ids": np.asarray(ids),
                "records": [self.records[i] for i in ids],
                "tables": {"wp_xy": cpu(st.wp.xy), "wp_count": cpu(st.wp.count),
                           "plan_xy": cpu(cache.plan_xy), "plan_count": cpu(cache.plan_count),
                           "goal_xy": cpu(cache.goal_xy), "goal_yaw": cpu(cache.goal_yaw),
                           "success": cpu(cache.success), "nonfinite": cpu(cache.nonfinite),
                           "guards": cpu(lite.guards)},
                "cluster_total": cpu(lite.cluster_total).numpy(),
                "feasible": cpu(acc["feasible"]).numpy()}

    def release(self):
        self.blocks = None
        self.compared, self.compared_groups = {}, []


def check(ctx, produced):
    from portbench.reference.sustained_rollouts_check import check as ref_check

    return ref_check(ctx, produced)


def control(ctx, produced, dtype):
    from portbench.reference.sustained_rollouts_check import control as ref_control

    return ref_control(ctx, produced, dtype)
