"""The port's float32 kernel structure differentiated against the JAX
package's float32 Pallas path.

The port runs here with the kernels' plain twins (forward K1/K2, backward
through the twins of K3/K4/K5); the JAX package under
``PYMRA_PALLAS=force`` runs its Pallas kernels in interpret mode and their
custom VJPs. The same inputs go to both. Tolerance: rtol 2e-4 on the value
and both gradients — each float32 gradient lies ~1e-5 from the float64 one
and the two round in different places (on grid32_fused they lie 1.3e-5
and 1.4e-5 apart).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from pymra_tpu.tree.model import MRAModel as JaxMRAModel
from pymra_torch import MRAModel
from pymra_torch.ops import linalg as tl
from pymra_torch.utils import gen_locations_2d

from tests.test_torch_loglik import (
    _assert_value_and_grad,
    _clustered,
    _jax_value_and_grad,
    _obs,
    _port_value_and_grad,
)
from tests.torch_fixtures import one_torch_thread  # noqa: F401
from tests.torch_fixtures import jax_native_planner  # noqa: F401


F32_CONFIGS = {
    # 16 leaves of P = 64 under grouped interior levels: leaf_factor
    "grid32_fused": (lambda: gen_locations_2d(32),
                     dict(r=4, M=2, J=4), 0.05, 0.1),
    # leaves at levels 2 (P = 5: cholesky_jittered + triangular solves)
    # and 3 (P = 23: leaf_factor)
    "clustered_mixed": (_clustered, dict(r=4, M=3), 0.1, 0.1),
}


@pytest.mark.parametrize("name", sorted(F32_CONFIGS))
def test_float32_kernel_structure_gradient_matches_pallas(name,
                                                          monkeypatch):
    from pymra_tpu.ops.pallas import linalg as jl

    make_locs, kw, l, R = F32_CONFIGS[name]
    locs = make_locs()
    y = _obs(len(locs))
    monkeypatch.setenv("PYMRA_PALLAS", "force")
    jl.pallas_available.cache_clear()
    try:
        want = _jax_value_and_grad(JaxMRAModel(locs, dtype=jnp.float32,
                                               **kw), y, R, l, 1.0)
    finally:
        monkeypatch.delenv("PYMRA_PALLAS")
        jl.pallas_available.cache_clear()

    calls = dict.fromkeys(["leaf_factor_ref", "cholesky_jittered_ref",
                           "cholesky_ref", "triangular_inverse_lower_ref",
                           "solve_triangular_batched_ref"], 0)

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    for twin in calls:
        monkeypatch.setattr(tl, twin, counted(twin, getattr(tl, twin)))
    got = _port_value_and_grad(
        MRAModel(locs, dtype=torch.float32, device="cpu", **kw), y, R, l,
        1.0)
    # forward and backward went through every wrapper the card launches
    assert all(calls.values()), calls
    _assert_value_and_grad(got, want, rtol=2e-4)
