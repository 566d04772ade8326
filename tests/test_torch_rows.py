"""The port's ``perceive.rows.compact_cells`` and the union-find chain on it
against the JAX package's, on the masks of tests/test_rows.py: random masks
at four densities (isolated cells, zigzag chains, near-dense blobs, whose run
buffers overflow) and the diagonal staircase (every cell its own run, one
chain).

Both packages take the same mask through compact_cells, run_level_labels,
neighbor_table, union_find_labels over the six non-E/W neighbours from
run_collapse_init: every output (compact list, inverse map, neighbour table,
labels, overflow) is bitwise JAX's. JAX's chain is one jit shared by every
case (one compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aosx.config import TEST_STATICS as JS
from aosx.perceive import rows as jrows
from aosx_torch.config import TEST_STATICS as S
from aosx_torch.perceive import rows
from torch_helpers import assert_same, one_torch_thread  # noqa: F401

SIX = [0, 1, 2, 5, 6, 7]


def _chain(m, cells, s):
    """compact_cells -> run-level labels, neighbour table, cell-level labels."""
    cell_flat, cell_ok, inv = m.compact_cells(cells, s)
    L_fast, overflow = m.run_level_labels(cell_flat, cell_ok, s.grid_h, s.grid_w, s)
    nbrs = m.neighbor_table(cell_flat, cell_ok, inv, s.grid_h, s.grid_w)
    L_cell = m.union_find_labels(nbrs[:, SIX], s,
                                 L0=m.run_collapse_init(cell_flat, cell_ok, s.grid_w))
    return dict(cell_flat=cell_flat, cell_ok=cell_ok, inv=inv, L_fast=L_fast,
                overflow=overflow, nbrs=nbrs, L_cell=L_cell)


@pytest.fixture(scope="module")
def jax_chain():
    return jax.jit(lambda mask: _chain(jrows, mask, JS))


def _random_mask(seed, density):
    rng = np.random.default_rng(seed)
    mask = np.zeros((S.grid_h, S.grid_w), bool)
    mask[:48, :64] = rng.random((48, 64)) < density
    return mask


def _staircase():
    mask = np.zeros((S.grid_h, S.grid_w), bool)
    side = min(S.grid_h, S.grid_w, 200)
    mask[np.arange(side), np.arange(side)] = True
    return mask


@pytest.mark.parametrize("case", ["0-0.08", "1-0.25", "2-0.6", "3-0.02", "staircase"])
def test_compact_cells_chain_matches_jax(jax_chain, case):
    if case == "staircase":
        mask = _staircase()
    else:
        seed, density = case.split("-")
        mask = _random_mask(int(seed), float(density))
    ref = jax_chain(jnp.asarray(mask))
    got = _chain(rows, torch.from_numpy(mask), S)
    assert_same(ref, got)
    n = int(mask.sum())
    assert int(got["cell_ok"].sum()) == min(n, S.max_skel_cells)
    assert int(got["inv"][-1]) == S.max_skel_cells
    if case == "staircase":
        # one component rooted at compact index 0
        assert not bool(got["overflow"]) and (got["L_fast"][:n] == 0).all()
    if not bool(got["overflow"]):
        assert torch.equal(got["L_fast"], got["L_cell"])


def test_compact_cells_world_axis():
    """A leading world axis compacts each mask on its own."""
    masks = np.stack([_random_mask(0, 0.08), _staircase(), np.zeros_like(_staircase())])
    got = rows.compact_cells(torch.from_numpy(masks), S)
    for g, mask in enumerate(masks):
        one = rows.compact_cells(torch.from_numpy(mask), S)
        assert all(torch.equal(a[g], b) for a, b in zip(got, one))
