"""The port's configuration, guard bits and orchard generator agree with
the JAX package's field for field."""

import dataclasses

import numpy as np
import pytest
import torch

import aosx.config as jc
import aosx.guards as jg
import aosx.orchards as jo
import aosx_torch.config as tc
import aosx_torch.guards as tg
import aosx_torch.orchards as to

PRESETS = ["TEST_STATICS", "DRYRUN_STATICS", "MC_STATICS", "MC_REALISM_STATICS",
           "BENCH_STATICS"]


@pytest.mark.parametrize("name", PRESETS)
def test_statics_presets_match(name):
    assert dataclasses.asdict(getattr(tc, name)) == dataclasses.asdict(getattr(jc, name))
    assert getattr(tc, name).inflation_cells == getattr(jc, name).inflation_cells


@pytest.mark.parametrize("h,w,res,over", [
    (2000, 2048, 0.1, {}),
    (4000, 4096, 0.05, {}),
    (8000, 8192, 0.1, {"max_rows": 7}),
    (1000, 1000, 0.05, {}),
])
def test_for_grid_matches(h, w, res, over):
    assert (dataclasses.asdict(tc.Statics.for_grid(h, w, res, **over))
            == dataclasses.asdict(jc.Statics.for_grid(h, w, res, **over)))


def test_statics_rounding():
    s = tc.Statics(grid_h=381, grid_w=500)
    assert (s.grid_h, s.grid_w) == (384, 512)
    assert [f.name for f in dataclasses.fields(tc.Statics)] == \
        [f.name for f in dataclasses.fields(jc.Statics)]


def test_aos_params_fields_and_defaults():
    assert dataclasses.asdict(tc.AosParams()) == dataclasses.asdict(jc.AosParams())
    assert [f.name for f in dataclasses.fields(tc.AosParams)] == \
        [f.name for f in dataclasses.fields(jc.AosParams)]


def test_params_as_f32_dtypes_and_values():
    pt = tc.params_as_f32(tc.AosParams(), "cpu")
    pj = jc.params_as_f32(jc.AosParams())
    for f in dataclasses.fields(tc.AosParams):
        a = np.asarray(getattr(pj, f.name))
        b = getattr(pt, f.name)
        assert isinstance(b, torch.Tensor) and b.dim() == 0 and b.device.type == "cpu"
        assert b.numpy().dtype == a.dtype, f.name
        assert b.numpy().tobytes() == a.tobytes(), f.name


def test_guard_bits_match():
    assert {k: v for k, v in vars(tg).items() if k.startswith("GUARD_")} == \
        {k: v for k, v in vars(jg).items() if k.startswith("GUARD_")}
    assert tg.describe(0xFFF) == jg.describe(0xFFF)


@pytest.mark.parametrize("spec_kw", [{}, {"row_curve": 0.8, "dropout": 0.15},
                                     {"n_rows": 20, "row_len": 180.0, "row_spacing": 9.0}])
def test_make_orchard_np_copy_matches(spec_kw):
    xt, pt_ = to.make_orchard_np(to.OrchardSpec(**spec_kw), seed=3)
    xj, pj_ = jo.make_orchard_np(jo.OrchardSpec(**spec_kw), seed=3)
    assert np.array_equal(xt, xj) and np.array_equal(pt_, pj_)
