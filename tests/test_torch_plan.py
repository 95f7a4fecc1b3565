"""The port's numpy planner against the JAX package's: bit-identical plans.

``pymra_torch`` carries its own copy of the planner (it must not import
JAX). These tests hold every padded level array of both planners equal on
five configurations that exercise the 2-D k-means (sklearn and native
C++), the 1-D exact-screening splits and leaves at several depths.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from pymra_tpu.data.loader import load_data as jax_load_data
from pymra_tpu.tree.plan import PlanConfig as JaxPlanConfig
from pymra_tpu.tree.plan import build_plan as jax_build_plan
from pymra_tpu.tree.sweep import make_device_plan as jax_make_device_plan
from pymra_torch.data.loader import load_data
from pymra_torch.tree.plan import LevelGroup, PlanConfig, build_plan
from pymra_torch.tree.sweep import plan_groups, plan_post_inv
from pymra_torch.utils import gen_locations, gen_locations_2d


def clustered_locs():
    return np.random.default_rng(1).random((300, 2)) ** 3


def _configs():
    small_locs, _ = load_data("small")
    return {
        # bundled small dataset, README example config (sklearn k-means)
        "bundled_small": (small_locs, dict(r=4), None),
        # README 1-D MLE recipe: exact-screening J = r + 1 splits
        "readme_1d": (gen_locations(100), dict(r=2, M=3, J=3), None),
        # 2-D grid through the native C++ k-means
        "grid32_native": (gen_locations_2d(32), dict(r=4), "native"),
        # leaves at two depths (levels 4 and 5), not grouped under parents
        "multi_leaf_1d": (gen_locations(100), dict(r=3, J=2), None),
        # clustered 2-D points: leaves at levels 2 (P=5) and 3 (P=23)
        "clustered_2d": (clustered_locs(), dict(r=4, M=3), None),
    }


CONFIGS = ["bundled_small", "readme_1d", "grid32_native", "multi_leaf_1d",
           "clustered_2d"]


def _plans(name):
    locs, kw, impl = _configs()[name]
    cfg = PlanConfig(r=kw["r"], kmeans_impl=impl) if impl else None
    jcfg = JaxPlanConfig(r=kw["r"], kmeans_impl=impl) if impl else None
    return (build_plan(locs, **kw, config=cfg),
            jax_build_plan(locs, **kw, config=jcfg))


@pytest.mark.parametrize("name", CONFIGS)
def test_plan_arrays_bit_identical(name):
    ours, ref = _plans(name)
    assert (ours.M, ours.J, ours.r) == (ref.M, ref.J, ref.r)
    assert len(ours.levels) == len(ref.levels)
    np.testing.assert_array_equal(ours.locs, ref.locs)
    for a, b in zip(ours.levels, ref.levels):
        assert a.level == b.level
        for f in dataclasses.fields(LevelGroup):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    np.testing.assert_array_equal(ours.leaf_sizes(), ref.leaf_sizes())
    assert ours.describe() == ref.describe()


@pytest.mark.parametrize("name", CONFIGS)
def test_device_plan_metadata_matches(name):
    ours, ref = _plans(name)
    jd = jax_make_device_plan(ref)
    assert tuple(plan_groups(ours)) == tuple(jd.groups)
    np.testing.assert_array_equal(plan_post_inv(ours),
                                  np.asarray(jd.post_inv))


@pytest.mark.parametrize("name", ["multi_leaf_1d", "clustered_2d"])
def test_configs_have_several_leaf_levels(name):
    ours, _ = _plans(name)
    assert sum(1 for g in ours.levels if g.n_leaf) >= 2


def test_bundled_data_read_by_path_matches():
    y, locs, y_obs = load_data("small", include_truth=True)
    y2, locs2, y_obs2 = jax_load_data("small", include_truth=True)
    np.testing.assert_array_equal(locs, locs2)
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(y_obs, y_obs2)
    with pytest.raises(ValueError):
        load_data("medium")


def test_native_kmeans_raises_without_library(monkeypatch):
    # an explicit native request never falls back to the numpy Lloyd, which
    # would plan a different tree
    from pymra_torch.ops import native

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "load_library", broken)
    with pytest.raises(RuntimeError, match="no compiler"):
        build_plan(gen_locations_2d(12), 4,
                   config=PlanConfig(r=4, kmeans_impl="native"))
