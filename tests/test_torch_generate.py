"""The port's dataset generator against the committed bundled data.

``pymra_torch.data.generate`` is the JAX package's generator in numpy
alone: from the documented seed it must write the committed ``small`` set
bit for bit, and only into the directory it is given. (The ``large`` set
factors a dense 10^4 x 10^4 covariance and is not regenerated here.)
"""
import os

import numpy as np

from pymra_torch.data import generate
from pymra_torch.data.loader import data_dir

NAMES = ("locs", "y", "y_obs")


def _committed(size):
    return {n: np.load(os.path.join(data_dir(size), f"{n}.npy"))
            for n in NAMES}


def test_simulate_reproduces_the_committed_small_set():
    got = dict(zip(NAMES, generate._simulate(10, generate.SEED + 10)))
    for name, want in _committed("small").items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        np.testing.assert_array_equal(got[name], want)
        # bit for bit, NaN at the same unobserved locations
        assert got[name].tobytes() == want.tobytes()


def test_generate_writes_only_under_the_named_directory(tmp_path):
    assert generate.main([str(tmp_path), "--sets", "small"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["small"]
    assert sorted(os.listdir(tmp_path / "small")) == [
        f"{n}.npy" for n in NAMES]
    for name, want in _committed("small").items():
        got = np.load(tmp_path / "small" / f"{name}.npy")
        assert got.tobytes() == want.tobytes()
    assert generate.generate(str(tmp_path), ["small"]) == {"small": (100, 86)}
