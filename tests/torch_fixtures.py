"""Fixtures shared by the port's test modules (``tests/test_torch_*.py``).

A module takes one by importing it (``from tests.torch_fixtures import
jax_native_planner  # noqa: F401``), which makes an autouse fixture apply
to every test of that module.
"""
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_native_planner():
    """Point the JAX package's native planner binding at the port's
    library before the module plans a reference.

    The binding compiles ``csrc/planner.cpp`` with ``g++ -o`` straight to
    its final path and gives up for good after one failed load, silently
    planning with the numpy Lloyd instead (another tree: the N=250k golden
    tree's objective becomes 4042412.131203). Under parallel test workers,
    one worker can load the half-written file another worker's compiler is
    still writing. The port's library comes from the same source and flags
    and is built under a private name and renamed into place, so the
    binding loads that one and a port test never writes the binding's
    file. The binding keeps it for the rest of the process.
    """
    from pymra_tpu.ops import native as jax_native
    from pymra_torch.ops import native

    so = native.load_library()._name
    if jax_native._LIB is None or jax_native._LIB._name != so:
        jax_native._LIB = None
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_native, "_lib_path", lambda: so)
            # no mtime-based rebuild: the port's library name already
            # carries a digest of the source
            mp.setattr(jax_native, "_source_path", lambda: "")
            mp.setattr(jax_native, "_TRIED", False)
            jax_native.available()
    assert jax_native.available() and jax_native._LIB._name == so, (
        "the JAX package's native planner did not load the port's library; "
        "its reference plans could silently use the numpy k-means")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread per test, restored after it. A parallel
    pytest run keeps every core busy; torch's own thread pool on top of it
    oversubscribes them, and the wide-leaf and dense-R rehearsals of
    ``chip_smoke.py`` then ran many times slower. The port's heavier test
    modules import this fixture, which makes it autouse there too."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
