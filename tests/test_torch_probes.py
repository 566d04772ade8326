"""Probes P1-P3 of the port (aosx_torch/probes.py) against the TPU probe
bodies of benchmarks/probe_pallas_prims.py in Pallas interpret mode.

The JAX side is tests/torch_reference/make_probes_reference.py, run in a
subprocess: the probe module sets JAX_COMPILATION_CACHE_DIR (setdefault) and
two jax.config cache options when it is imported, so the variable points at
the test's temporary directory and neither the repository's cache nor this
worker's jax config is touched. Every comparison is bitwise (all values are
32-bit integers). Beside them, the plain mirrors of the kernels' schemes
(P1's chain with each load ahead of the store before it, P3's staged-row
layout and carried index) against the plain versions, and the count of
bank wavefronts that P3's indices force."""

import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from aosx_torch import cuda_build, probes
from torch_helpers import cuda_device, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "tests" / "torch_reference"
CPU = torch.device("cpu")


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a).astype("<i4")).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """(json summary, full arrays) of the Pallas bodies in interpret mode."""
    tmp = tmp_path_factory.mktemp("probes")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, str(REF_DIR / "make_probes_reference.py"),
                        "--out", str(tmp / "probes.json"), "--npz", str(tmp / "probes.npz")],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads((tmp / "probes.json").read_text()), np.load(tmp / "probes.npz")


def test_committed_reference_is_current(pallas):
    """tests/torch_reference/probes.json holds what the Pallas bodies give."""
    summary, _ = pallas
    committed = json.loads((REF_DIR / "probes.json").read_text())
    for k in summary:
        if k != "jax":
            assert committed[k] == summary[k], k


def test_p1_chase_rw_matches_pallas(pallas):
    summary, arrays = pallas
    c, table = probes.chase_rw(probes.seed_tensor(CPU))
    assert c.dtype == torch.int32 and table.dtype == torch.int32
    assert np.array_equal(c.numpy(), arrays["p1_c"])
    # the Pallas body keeps its table; the reference's numpy transcription,
    # which reproduces the body's c, supplies it
    assert np.array_equal(table.numpy(), arrays["p1_table"])
    assert _sha(table.numpy()) == summary["p1_table_sha256"]


def test_p2_chase_ro_matches_pallas(pallas):
    _, arrays = pallas
    c = probes.chase_ro(probes.seed_tensor(CPU))
    assert c.dtype == torch.int32
    assert np.array_equal(c.numpy(), arrays["p2_c"])


def test_p3_gather_rows_matches_pallas(pallas):
    summary, arrays = pallas
    x, idx = probes.gather_rows_inputs(CPU)
    out = probes.gather_rows(x, idx)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), arrays["p3"])
    assert int(out.sum(dtype=torch.int64)) == summary["p3_sum"]
    assert out[0, :4].tolist() == summary["p3_first4"]


def test_p4_flat_gather_matches_xla(pallas):
    _, arrays = pallas
    occ, idx = probes.flat_gather_inputs(CPU)
    assert np.array_equal(idx.numpy(), arrays["p4_idx"])  # the wrapped i32 product
    assert np.array_equal(probes.flat_gather_plain(occ, idx).numpy(), arrays["p4"])


def _chase_numpy(n, steps, seed, write):
    parent = np.arange(n, dtype=np.int64)
    c = seed & 0xFFFFFFFF
    for i in range(steps):
        j = ((c * 1103515245 + 12345) & 0xFFFFFFFF) & (n - 1)
        v = int(parent[j])
        if write:
            parent[(j + 1) & (n - 1)] = v
        c = (v ^ i) & 0xFFFFFFFF
    return np.array(c, np.uint32).astype(np.int32), parent.astype(np.int32)


@pytest.mark.parametrize("seed", [3, 0, -7, 2**31 - 1, -2**31])
def test_chase_wraps_like_int32(seed):
    """Seeds whose multiply-add overflows, negative ones too: the i64 arithmetic
    with the wrap written out equals a numpy transcription of the bodies."""
    c, table = probes.chase_rw_plain(probes.seed_tensor(CPU, seed), n=1024, steps=700)
    c_np, table_np = _chase_numpy(1024, 700, seed, write=True)
    assert int(c) == int(c_np) and np.array_equal(table.numpy(), table_np)
    c = probes.chase_ro_plain(probes.seed_tensor(CPU, seed), steps=700)
    assert int(c) == int(_chase_numpy(probes.P2_N, 700, seed, write=False)[0])


def test_gather_rows_wraps_like_int32():
    """Values near 2^31 make acc overflow: torch's i32 add wraps as numpy's."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2**31, 2**31, (4, probes.P3_COLS), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, probes.P3_COLS, (4, probes.P3_COLS)).astype(np.int32)
    acc = np.zeros_like(x)
    with np.errstate(over="ignore"):
        for _ in range(5):
            acc = acc + np.take_along_axis(x, (idx + acc) & (probes.P3_COLS - 1), axis=1)
    got = probes.gather_rows_plain(torch.from_numpy(x), torch.from_numpy(idx), rounds=5)
    assert np.array_equal(got.numpy(), acc)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (probes.chase_rw.launches, probes.chase_ro.launches, probes.gather_rows.launches)
    probes.chase_rw(probes.seed_tensor(CPU), n=64, steps=10)
    probes.chase_ro(probes.seed_tensor(CPU), steps=10)
    probes.gather_rows(*probes.gather_rows_inputs(CPU, rows=2), rounds=2)
    assert before == (probes.chase_rw.launches, probes.chase_ro.launches,
                      probes.gather_rows.launches)


def test_shared_load_clocks_measures_only_the_card():
    with pytest.raises(ValueError):
        probes.shared_load_clocks(CPU)


def test_timed_ms_takes_a_fresh_input_outside_the_window():
    """The timing helper of the probes and of chip_smoke.py: the warm-up
    call's result, and one fresh setup() for each call."""
    made, seen = [], []

    def setup():
        made.append(len(made))
        return made[-1]

    out, ms = cuda_build.timed_ms(lambda k: seen.append(k) or k * 10, CPU, 3, setup)
    assert out == 0 and seen == made == [0, 1, 2, 3] and ms >= 0
    out, _ = cuda_build.timed_ms(lambda: "once", CPU, 1)
    assert out == "once"


def test_probe_entry_point_on_the_cpu(capsys):
    probes.main(["p2", "p3b", "p4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["P2", "P3b", "P4"]
    ref = json.loads((REF_DIR / "probes.json").read_text())
    assert f"c = {ref['p2_c']}" in lines[0]
    assert f"sum = {ref['p3_sum']}" in lines[1]
    assert f"sum = {ref['p4_sum']}" in lines[2]


# ---------------------------------------------------------------------------
# the kernels' schemes, mirrored in plain code
# ---------------------------------------------------------------------------

SEEDS = [3, 0, -7, 2**31 - 1, -2**31]


@pytest.mark.parametrize("n", [16, 64, 1024])
@pytest.mark.parametrize("seed", SEEDS)
def test_p1_pipelined_chain_matches_plain(seed, n):
    """P1's shared-memory chain (each load ahead of the store before it, the
    forward folded into the xor) equals the plain loop bitwise, on tables
    small enough that a step often reads the entry the step before wrote."""
    s = probes.seed_tensor(CPU, seed)
    c, table, forwards = probes.chase_rw_pipelined_plain(s, n=n, steps=4096)
    c_p, table_p = probes.chase_rw_plain(s, n=n, steps=4096)
    assert forwards > 0
    assert torch.equal(c, c_p) and torch.equal(table, table_p)


def test_p1_pipelined_chain_on_the_probe():
    """The full probe: the Pallas body's constants, and the 2 forwards of
    seed 3 over 65,536 steps."""
    ref = json.loads((REF_DIR / "probes.json").read_text())
    c, table, forwards = probes.chase_rw_pipelined_plain(probes.seed_tensor(CPU, ref["seed"]))
    assert int(c) == ref["p1_c"] and _sha(table.numpy()) == ref["p1_table_sha256"]
    assert forwards == 2


def test_p3_layout_is_a_bijection_of_the_staged_row():
    words = probes.gather_layout(torch.arange(probes.P3_COLS))
    assert int(words.min()) >= 0 and int(words.max()) < probes.P3_SMEM_WORDS
    assert torch.unique(words).numel() == probes.P3_COLS
    lanes = probes.gather_lanes()
    assert torch.equal(torch.sort(lanes.flatten()).values, torch.arange(probes.P3_COLS))


@pytest.mark.parametrize("words, want", [
    ([5] * 32, 1),                       # one address: a broadcast
    ([32 * k for k in range(32)], 32),   # stride 32: one bank
    (list(range(32)), 1),                # stride 1: 32 banks
    ([2 * k for k in range(32)], 2),     # stride 2: 16 banks, two words each
    ([7] * 16 + [39] * 16, 2),           # two words of one bank
])
def test_bank_wavefronts_hand_cases(words, want):
    assert probes.bank_wavefronts(torch.tensor([words])).tolist() == [want]


def test_gather_wavefronts_on_the_probe_input():
    """Rows of the probe input are all equal, so one row gives the mean of
    512: 3.4697 wavefronts a warp-load with consecutive columns in a warp and
    the identity layout; with the kernel's lanes 3.4985 there and 1.125 in
    its layout. On random input the layout cannot help."""
    x, idx = probes.gather_rows_inputs(CPU, rows=1)

    def identity(a):
        return a

    consecutive = torch.arange(probes.P3_COLS).reshape(-1, 32)
    assert probes.gather_wavefronts(x, idx, layout=identity, lanes=consecutive) == 3.4697265625
    assert probes.gather_wavefronts(x, idx, layout=identity) == 3.49853515625
    assert probes.gather_wavefronts(x, idx) == 1.125
    xr, idxr = probes.gather_rows_random_inputs(CPU, rows=4)
    assert 2.5 < probes.gather_wavefronts(xr, idxr) < 3.5


@pytest.mark.parametrize("inputs", ["probe", "random"])
def test_p3_layout_mirror_matches_plain(inputs):
    """The kernel's scheme (staged row through the layout, carried index)
    equals the plain rounds bitwise, wrapping sums included."""
    if inputs == "probe":
        x, idx = probes.gather_rows_inputs(CPU, rows=2)
    else:
        x, idx = probes.gather_rows_random_inputs(CPU, rows=8)
    assert torch.equal(probes.gather_rows_layout_plain(x, idx), probes.gather_rows_plain(x, idx))


def test_p3_pallas_body_on_random_input(pallas):
    """taa_kernel in interpret mode on 8 rows of random i32 x and idx
    (negative values, wrapping sums) equals the plain version."""
    _, arrays = pallas
    x, idx = (torch.from_numpy(arrays[k]) for k in ("p3_random_x", "p3_random_idx"))
    assert (x < 0).any()
    assert np.array_equal(probes.gather_rows_plain(x, idx).numpy(), arrays["p3_random"])


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, bitwise
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chase_reference(seed, n, steps):
    return _chase_numpy(n, steps, seed, write=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", [16, 1024, 65536])
@pytest.mark.parametrize("seed", SEEDS)
def test_p1_kernel_matches_plain(cuda_device, shared, n, seed):
    """Both table forms against the numpy transcription, which the CPU tests
    hold equal to chase_rw_plain."""
    n0 = probes.chase_rw.launches
    c, table = probes.chase_rw(probes.seed_tensor(cuda_device, seed), n=n, shared=shared)
    c_p, table_p = _chase_reference(seed, n, probes.P1_STEPS)
    assert probes.chase_rw.launches == n0 + 1
    assert int(c) == int(c_p) and np.array_equal(table.cpu().numpy(), table_p)


@pytest.mark.cuda
def test_p1_table_form_by_size(cuda_device):
    """A table over 65,536 entries runs in global memory; in shared memory,
    the default, it raises."""
    seed = probes.seed_tensor(cuda_device)
    c, table = probes.chase_rw(seed, n=2**17, steps=4096, shared=False)
    c_p, table_p = _chase_reference(probes.SEED, 2**17, 4096)
    assert int(c) == int(c_p) and np.array_equal(table.cpu().numpy(), table_p)
    with pytest.raises(ValueError):
        probes.chase_rw(seed, n=2**17)
    c, _ = probes.chase_rw(seed)
    assert torch.equal(c, probes.chase_rw_plain(seed.cpu())[0].to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_shared_load_clocks(cuda_device, wide):
    """The chase ends where the table says, at a load-to-use latency of tens
    of clocks."""
    assert 10 < probes.shared_load_clocks(cuda_device, wide=wide) < 100


@pytest.mark.cuda
def test_p2_kernel_matches_plain(cuda_device):
    seed = probes.seed_tensor(cuda_device)
    n0 = probes.chase_ro.launches
    assert torch.equal(probes.chase_ro(seed), probes.chase_ro_plain(seed))
    assert probes.chase_ro.launches == n0 + 1


@pytest.mark.cuda
def test_p3_kernel_matches_plain(cuda_device):
    x, idx = probes.gather_rows_inputs(cuda_device)
    n0 = probes.gather_rows.launches
    assert torch.equal(probes.gather_rows(x, idx), probes.gather_rows_plain(x, idx))
    assert probes.gather_rows.launches == n0 + 1
    with pytest.raises(ValueError):
        probes.gather_rows(x[:, :1024].contiguous(), idx[:, :1024].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 512])
def test_p3_kernel_on_random_input(cuda_device, rows):
    x, idx = probes.gather_rows_random_inputs(cuda_device, rows=rows)
    n0 = probes.gather_rows.launches
    assert torch.equal(probes.gather_rows(x, idx), probes.gather_rows_plain(x, idx))
    assert probes.gather_rows.launches == n0 + 1
