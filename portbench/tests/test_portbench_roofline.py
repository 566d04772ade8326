"""The benchmark's copy of the kernels' roofline arithmetic gives
chip_smoke.py's bounds, at BENCH_STATICS and MC_STATICS shapes."""

import pathlib
import sys

import pytest

from portbench.harness import roofline

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("preset", ["BENCH_STATICS", "MC_STATICS"])
def test_bounds_match_chip_smoke(smoke, preset):
    from aosx_torch import config

    S = getattr(config, preset)
    H, W, n = S.grid_h, S.grid_w, S.max_seeds
    assert roofline.bound(8 * H * W + 8 * (n + 1)) == smoke.bound(8 * H * W + 8 * (n + 1))
    assert roofline.k1_bytes_ms(3, H, W, n) == smoke.bound(3 * (8 * H * W + 8 * (n + 1)))[0]
    assert roofline.k2_bytes_ms(2, H, W) == smoke.bound(2 * 2 * H * W)[0]
    assert roofline.k2_ops_ms([10, 17], [H * W // 64, 123]) == smoke.bound(
        0, int32_ops=sum(i * 2.0 * smoke.K2_OPS_PER_WORD * w
                         for i, w in zip([10, 17], [H * W // 64, 123])))[0]
    assert roofline.k3_bound(1, S.max_points)[:2] == smoke.k3_bound(1, S.max_points)[:2]
