"""The cases of the register-tiled K1 ``leaf_factor`` and K4 ``cholesky``
kernels, on the CPU through their plain twins.

The kernels pad a member to a width tier and escalate per member; the
card's check (``chip_smoke.py`` phase 3) holds them to the twins on the
members built here. These tests hold those members' twin results to the
JAX package's Pallas kernels (interpret mode, as ``tests/test_pallas.py``
runs them) and check that each member really is the case it is named for:
escalated to 1e2 and to 1e4, failing all three factors, fully masked, an
exactly zero pivot. Float32 tolerances as ``tests/test_torch_linalg.py``:
rtol 1e-4 / atol 1e-5, selected factors identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import chip_smoke
from pymra_tpu.ops.pallas import linalg as jl
from pymra_torch.ops import linalg as tl
from tests.test_torch_grad import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("p, tier", [
    (1, 16), (4, 16), (8, 16), (16, 16), (17, 32), (28, 32), (32, 32),
    (33, 48), (48, 48), (49, 64), (64, 64)])
def test_tile_tier_is_the_least_tier_holding_p(p, tier):
    assert tl.tile_tier(p) == tier


@pytest.mark.parametrize("p", [0, 65])
def test_tile_tier_refuses_widths_outside_one_block(p):
    with pytest.raises(ValueError, match="outside"):
        tl.tile_tier(p)


def _jax_leaf(c, k, a, jitter):
    out = jl._leaf_factor_tuple(
        jnp.asarray(c, dtype=jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(a, dtype=jnp.float32), jitter, tl.FACTORS)
    return [np.asarray(o) for o in out]


# 6: a batch that is not a multiple of any tile or group
@pytest.mark.parametrize("p", [17, 49])
def test_leaf_hard_members_match_pallas(p):
    c, k, a = chip_smoke.leaf_case(np.random.default_rng(p), 6, p,
                                   escalate=True, hard=True)
    jitter = 1e-3
    got = [o.numpy() for o in tl.leaf_factor(
        torch.as_tensor(c), torch.as_tensor(k), torch.as_tensor(a), jitter)]
    want = _jax_leaf(c, k, a, jitter)
    li, ldp, ldq, fp, fq = got
    # members 0, 4, 5 at the base factor, 1 at 1e2, 2 at 1e4, 3 fails all
    for f in (fp, fq):
        assert f.tolist() == [1.0, 1e2, 1e4, 1e4, 1.0, 1.0]
    np.testing.assert_array_equal(fp, want[3])
    np.testing.assert_array_equal(fq, want[4])
    ok = [0, 1, 2, 4, 5]
    assert np.isfinite(ldp[ok]).all() and np.isfinite(ldq[ok]).all()
    assert np.isfinite(li[ok]).all()
    assert np.isnan(ldp[3]) and np.isnan(ldq[3]) and np.isnan(want[1][3])
    # the all-fail member is NaN from its failing column on, and zero
    # above the diagonal
    assert np.isnan(li[3][1:, :2]).all() and (np.triu(li[3], 1) == 0).all()
    np.testing.assert_allclose(ldp[ok], want[1][ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ldq[ok], want[2][ok], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(li[ok], want[0][ok], rtol=RTOL, atol=ATOL)
    # fully masked leaf: K_leaf = I, jitter scale 2
    np.testing.assert_allclose(li[0], np.eye(p) / np.sqrt(1 + 2 * jitter),
                               rtol=1e-6)


def test_leaf_hard_members_only_with_escalation():
    # phase 3b draws its leaves without the hard members: their inputs stay
    # as they were
    rng = [np.random.default_rng(3) for _ in range(2)]
    plain = chip_smoke.leaf_case(rng[0], 6, 17, escalate=True)
    hard = chip_smoke.leaf_case(rng[1], 6, 17, escalate=True, hard=True)
    for x, y in zip(plain, hard):
        np.testing.assert_array_equal(x[[0, 1, 4, 5]], y[[0, 1, 4, 5]])
    assert not np.array_equal(plain[0][2], hard[0][2])


@pytest.mark.parametrize("p", [4, 17, 64])
def test_cholesky_zero_pivot_member(p):
    # the member chip_smoke adds to K4's batch: exactly zero pivot at
    # column z with 0.5 under it; columns before z stay exact, L[z, z] is
    # 0/0 and L[z+1, z] is 0.5/0 = inf, and the trailing block is NaN
    z = p // 2
    m = np.eye(p, dtype=np.float32)
    m[z, z] = 0.0
    m[z + 1, z] = m[z, z + 1] = 0.5
    l = tl.cholesky(torch.as_tensor(m)[None])[0].numpy()
    np.testing.assert_array_equal(l[:, :z], np.eye(p, dtype=np.float32)[:, :z])
    assert np.isnan(l[z, z]) and np.isposinf(l[z + 1, z])
    assert np.isnan(l[z + 1:, z + 1:][np.tril_indices(p - z - 1)]).all()
    assert (np.triu(l, 1) == 0).all()
