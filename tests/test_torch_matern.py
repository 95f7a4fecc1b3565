"""The general-nu Matern on the card's path (``ops/cuda/csrc/matern.cu``,
``ops/special.py::matern_cuda``) and its plain twin, held by what runs on
the CPU.

* The kernel source compiled on the host (g++, no contraction; stubs for
  the CUDA rounding intrinsics) with its C entry points run entry by entry,
  bound through the port's own ctypes signatures and driven through
  ``matern_cuda`` and its autograd Function: at nu in {0.3, 0.8, 1.3, 2.2},
  on points and on distances with s on both sides of 2, at 2 and at d = 0,
  each value within half a float32 ulp of the float64 twin at the same
  float32 distances (the Bessel functions in float64, rounded once) and
  within chip_smoke's 1e-5 + 1e-4 max|twin| of the float32 twin, NaN where
  the twin's is; each gradient within 1e-6 of the twin's autograd,
  relative; one launch each way.
* The twin's K_nu and K_(nu-1) against ``scipy.special.kv`` (rtol 1e-10).
* The sweep's ``pymra.cov`` spans and ``cov_entries`` counter against the
  plan's blocks (none for a closed form), the pullback's ``pymra.bwd.cov``
  span, and the launch counters summed across modules.
* chip_smoke's phase 3d on the host build at a small shape, and failing
  when the pullback drops the variance's part.
* A ``Kernel`` named with its smoothness (``'matern(nu=0.8)'``, as the
  benchmark's configuration names it) and the names it refuses.
* The benchmark's pieces of the Matern cell: the plain reference's K_nu
  against scipy, the port's batched value and gradient on the CPU against
  that reference (and a wrong smoothness that the comparison rejects), the
  data maker's seed, and the configuration's smoothness.
"""
import ctypes
import json
import math
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch
from scipy.special import kv, kve

import chip_smoke
from portbench import harness
from portbench.datasets import grid_field, matern_field
from portbench.reference import mra_matern
from portbench.reference.planner import plan_tree
from portbench.traffic import value_and_grad
from pymra_torch import Kernel, MRAModel, PlanConfig, kernels
from pymra_torch.ops import linalg, special
from pymra_torch.ops.cuda import build, launch
from pymra_torch.utils import profiling

F64 = torch.float64
NUS = [0.3, 0.8, 1.3, 2.2]
#: room for the kernel's stop at 1e-10 of its sums, relative
STOP = 1e-9

# the CUDA names matern.cu uses, for compiling it on the host
_HOST_CUDA = """#pragma once
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline double __dsqrt_rn(double a) { return sqrt(a); }
"""
# the kernels' C entry points, their threads run one entry after another
# (the pullback's sums land in block 0, the forward's count of entries
# outside the table in the counter), and the lookup alone
_HOST_MAIN = """#include "matern.cu"
template <typename T>
static int fwd(const void* a, const void* b, const void* d, const void* l,
               const void* s, void* out, const void* table, void* fallback,
               double nu, int sets, long long pairs, int p, int q, int dim) {
  const Order o = order_of(nu);
  long long missed = 0;
  for (long long e = 0; e < pairs; ++e)
    missed += forward_entry((const T*)a, (const T*)b, (const T*)d,
                            (const T*)l, (const T*)s, (T*)out,
                            (const double*)table, o, sets, pairs, e, p, q,
                            dim);
  if (fallback != nullptr) *(long long*)fallback += missed;
  return 0;
}
template <typename T>
static int pull(const void* a, const void* b, const void* d, const void* l,
                const void* s, const void* g, const void* table,
                double* partial, int blocks, double nu, int sets,
                long long pairs, int p, int q, int dim) {
  const Order o = order_of(nu);
  for (int c = 0; c < sets; ++c) {
    const SetTerms st = set_terms((const T*)l, (const T*)s, o, c);
    double acc[2] = {0.0, 0.0};
    for (long long e = 0; e < pairs; ++e)
      pullback_entry((const T*)a, (const T*)b, (const T*)d, (const T*)g,
                     (const double*)table, o, st, c, pairs, e, p, q, dim,
                     acc);
    partial[(size_t)c * blocks] = acc[0] * st.dl;
    partial[(size_t)(sets + c) * blocks] = acc[1];
  }
  return 0;
}
extern "C" int pymra_matern(const void* a, const void* b, const void* d,
                            const void* l, const void* s, void* out,
                            const void* table, void* fallback, int f64,
                            double nu, int sets, long long pairs, int p,
                            int q, int dim, int, void*) {
  return (f64 ? fwd<double> : fwd<float>)(a, b, d, l, s, out, table,
                                          fallback, nu, sets, pairs, p, q,
                                          dim);
}
extern "C" int pymra_matern_pullback(const void* a, const void* b,
                                     const void* d, const void* l,
                                     const void* s, const void* g,
                                     const void* table, void* partial,
                                     int blocks, int f64, double nu,
                                     int sets, long long pairs, int p, int q,
                                     int dim, int, void*) {
  return (f64 ? pull<double> : pull<float>)(a, b, d, l, s, g, table,
                                            (double*)partial, blocks, nu,
                                            sets, pairs, p, q, dim);
}
// out [n, 4]: x^nu (K_nu, K_(nu-1)) as the kernels take them, then the
// table's e^x x^nu (K_nu, K_(nu-1)) where it covers x (NaN elsewhere);
// returns how many points the table covered
extern "C" int matern_pairs(double nu, const double* table, const double* x,
                            double* out, int n) {
  const Order o = order_of(nu);
  int covered = 0;
  for (int i = 0; i < n; ++i) {
    double* r = out + 4 * i;
    covered += pair_at<true>(x[i], table, o, r[0], r[1]);
    int idx;
    double t;
    r[2] = r[3] = NAN;
    if (locate(x[i], idx, t)) {
      r[2] = horner(table + idx * kCoefs, t);
      r[3] = horner(table + kFuncSize + idx * kCoefs, t);
    }
  }
  return covered;
}
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``matern.cu`` built on the host, its entry points typed as the
    port's build types them."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("matern_host")
    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    (tmp / "cuda_runtime.h").write_text(_HOST_CUDA)
    (tmp / "main.cpp").write_text(_HOST_MAIN)
    so = tmp / "libmatern.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(tmp), "-I", csrc,
                    str(tmp / "main.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ("pymra_matern", "pymra_matern_pullback",
                 "pymra_matern_table"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["matern_pairs"] = lib.matern_pairs
    fns["matern_pairs"].argtypes = [ctypes.c_double] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int]
    return types.SimpleNamespace(**fns)


@pytest.fixture
def on_host(host_library, monkeypatch):
    """``matern_cuda`` launching the host build on CPU tensors."""
    monkeypatch.setattr(special.build, "load_library", lambda: host_library)
    monkeypatch.setattr(special, "_on_card", lambda a, b: None)
    monkeypatch.setattr(special, "_where", lambda t: (0, 0))
    monkeypatch.setattr(special.matern_cuda, "launches", 0)
    monkeypatch.setattr(special.matern_cuda, "pullback_launches", 0)
    monkeypatch.setattr(special, "_TABLES", {})
    return special.matern_cuda


def _twin(d, l, sig, nu):
    """The twin at the float32 distances ``d`` and parameters, in float64,
    with its autograd leaves."""
    lt = torch.tensor(l, dtype=torch.float32).double().requires_grad_()
    st = torch.tensor(sig, dtype=torch.float32).double().requires_grad_()
    shape = (-1,) + (1,) * d.dim()
    return special.matern_general(d.double(), lt.reshape(shape),
                                  st.reshape(shape), nu), lt, st


def _dist(a, b):
    """The distances as the card computes them: differences, squares and
    their sum rounded in float32 each, the square root correctly rounded
    (the CPU's float32 ``torch.sqrt`` may be an ulp off)."""
    sq = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    return torch.sqrt(sq.double()).float()


def _points(seed):
    """Points of 3 blocks: distances from 0 (a shared point) to ~0.4."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.random((3, 9, 2)) * 0.3, dtype=torch.float32)
    b = torch.as_tensor(rng.random((3, 7, 2)) * 0.3, dtype=torch.float32)
    b[1, 2] = a[1, 4]
    return a, b


L_SETS = [0.05, 0.11, 0.02, 0.3, 0.07]  # 5 sets: two blocks of the pullback
SIG_SETS = [1.0, 1.3, 0.7, 2.0, 0.9]


def _against_twin(on_host, nu, pts, d):
    """The host build at the points ``pts`` (None: the distances ``d``,
    handed over as circular ones) against the twin at ``d``: values within
    half a float32 ulp (+ STOP relative) of the float64 twin and within
    chip_smoke's limit of the float32 twin, gradients within 1e-6."""
    l, sig = L_SETS, SIG_SETS
    lt = torch.tensor(l, dtype=torch.float32, requires_grad=True)
    st = torch.tensor(sig, dtype=torch.float32, requires_grad=True)
    shape = (-1,) + (1,) * d.dim()
    if pts is None:
        with pytest.MonkeyPatch.context() as mp:
            # circular distances go to the kernel as distances
            mp.setattr(special, "dist", lambda *a, **k: d)
            got = on_host(torch.zeros(1, 1, 1),
                          torch.zeros(1, d.shape[-1], 1), lt.reshape(shape),
                          st.reshape(shape), nu, circular=True)
    else:
        got = on_host(*pts, lt.reshape(shape), st.reshape(shape), nu)
    want, lw, sw = _twin(d, l, sig, nu)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got.double() - want).detach().abs()
    half_ulp = 0.5 * np.spacing(want.detach().float().abs().numpy())
    assert (err.numpy() <= half_ulp + STOP * want.detach().abs().numpy()
            + 2.0 ** -149).all(), err.max()  # (subnormal outputs)
    low = special.matern_general(d, lt.detach().reshape(shape),
                                 st.detach().reshape(shape), nu)
    chip_smoke.compare(f"matern nu={nu}", [got.detach()], [low])
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(got.shape)), dtype=torch.float32)
    (got * g).sum().backward()
    (want * g.double()).sum().backward()
    for mine, ref in ((lt.grad, lw.grad), (st.grad, sw.grad)):
        np.testing.assert_allclose(mine.double(), ref, rtol=1e-6)


@pytest.mark.parametrize("nu", NUS)
def test_host_built_kernel_is_the_twin(on_host, nu):
    root = math.sqrt(2.0 * nu)
    a, b = _points(int(nu * 10))
    # distances of s = 2 at l = 0.05 and next to it, d = 0
    d_two = np.float32(2.0 * np.float32(0.05) / root)
    extra = np.array([d_two, np.nextafter(d_two, np.float32(1)),
                      np.nextafter(d_two, np.float32(0)), 0.0, 1e-4, 0.9],
                     dtype=np.float32)
    dist = torch.as_tensor(extra).reshape(1, 1, -1)
    _against_twin(on_host, nu, (a, b), _dist(a, b))
    _against_twin(on_host, nu, None, dist)
    # a NaN distance or length scale gives NaN where the twin's is
    a[0, 1, 0] = float("nan")
    lt = torch.tensor([0.05, float("nan")])
    got = on_host(a, b, lt.reshape(-1, 1, 1, 1), 1.0, nu)
    d = _dist(a, b)
    want = special.matern_general(d, lt.reshape(-1, 1, 1, 1), 1.0, nu)
    assert torch.isnan(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert on_host.launches == 3 and on_host.pullback_launches == 2


#: the table's interval edges (matern.cu: 4 a octave from 2^-12 to 2^10)
EDGES = np.array([2.0 ** e * (1 + j / 4) for e in range(-12, 10)
                  for j in range(4)] + [2.0 ** 10])


@pytest.mark.parametrize("nu", NUS)
def test_host_built_kernel_is_the_twin_at_interval_edges(on_host, nu):
    """Distances whose s at l = 0.05 falls on the table's interval edges
    from 2^-6 to 2^6, and the float32 distances next to them: each side of
    an edge reads its own interval's polynomial."""
    root = math.sqrt(2.0 * nu)
    edges = EDGES[(EDGES >= 2.0 ** -6) & (EDGES <= 2.0 ** 6)]
    d = (edges * np.float32(0.05) / root).astype(np.float32)
    d = np.concatenate([d, np.nextafter(d, np.float32(1)),
                        np.nextafter(d, np.float32(0))])
    _against_twin(on_host, nu, None, torch.as_tensor(d).reshape(1, 1, -1))


def test_no_table_where_none_holds(on_host):
    """Above nu ~ 12 no table of the kernel's size holds 1e-10: the
    kernels get none and every entry takes the series or CF2, still the
    twin, and the forward counts every entry with s > 0."""
    nu = 20.0
    rec = special.matern_table(nu, "cpu")
    assert rec.table is None and rec.max_err > 1e-10
    a, b = _points(5)
    _against_twin(on_host, nu, (a, b), _dist(a, b))
    profiling.clear()
    with profiling.tracing(), profiling.trace_annotation("t"):
        on_host(a, b, torch.tensor([0.05, 0.3]).reshape(-1, 1, 1, 1), 1.0,
                nu)
    fell = profiling.spans()[-1]["counts"]["cov_fallback_entries"]
    assert fell == 2 * int((_dist(a, b) > 0).sum())


def _ends():
    """x_lo, x_hi, 2 and both ends of every interval of the table (its
    upper end from below)."""
    return np.concatenate([EDGES, np.nextafter(EDGES, 0.0), [2.0]])


@pytest.mark.parametrize("nu", [0.3, 0.5001, 0.8, 1.0, 1.3, 2.2, 3.7])
def test_table_holds_the_bessel_pair_to_scipy(host_library, nu):
    """The table ``matern.cu`` builds for nu, read through the kernels'
    lookup: e^x x^nu K_nu(x) and e^x x^nu K_(nu-1)(x) within 1e-10 of
    scipy on every interval (the polynomials themselves, up to x_hi), and
    x^nu (K_nu, K_(nu-1)) as the kernels take them, the series and CF2
    outside [x_lo, x_hi), where the value has not underflowed."""
    lib = host_library
    n = lib.pymra_matern_table(nu, None, 0, None)
    table, err = np.zeros(n), np.zeros(1)
    assert lib.pymra_matern_table(nu, table.ctypes.data, n,
                                  err.ctypes.data) == n
    assert n * 8 == 14080 and err[0] <= 1e-10
    x = np.concatenate([np.geomspace(1e-6, 1024.0, 2001), _ends()])
    out = np.zeros((len(x), 4))
    covered = lib.matern_pairs(nu, table.ctypes.data, x.ctypes.data,
                               out.ctypes.data, len(x))
    inside = (x >= 2.0 ** -12) & (x < 2.0 ** 10)
    assert covered == inside.sum() and np.isnan(out[~inside, 2:]).all()
    for k, order in enumerate((nu, nu - 1.0)):
        scaled = x[inside] ** nu * kve(order, x[inside])
        np.testing.assert_allclose(out[inside, 2 + k], scaled, rtol=1e-10)
        want = x ** nu * kv(order, x)
        live = want > 1e-300
        np.testing.assert_allclose(out[live, k], want[live], rtol=1e-10)


def test_kernel_takes_unbatched_and_float64(on_host):
    """A 0-dim float64 l on the host (an unbatched Kernel's) gets its
    gradient there; float64 points come out float64."""
    a, b = _points(3)
    lt = torch.tensor(0.07, dtype=F64, requires_grad=True)
    got = on_host(a, b, lt, 1.5, 0.8)
    d = _dist(a, b)
    want = special.matern_general(d.double(), torch.tensor(0.07, dtype=F64),
                                  1.5, 0.8)
    assert got.shape == (3, 9, 7)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
    got.sum().backward()
    assert lt.grad.dtype == F64 and lt.grad.device.type == "cpu"
    assert on_host(a.double(), b.double(), 0.07, 1.0, 0.8).dtype == F64
    with torch.no_grad():
        on_host(a, b, lt, 1.0, 0.8)
    assert on_host.launches == 3 and on_host.pullback_launches == 1


@pytest.mark.parametrize("nu", NUS)
def test_twin_against_scipy(nu):
    x = np.concatenate([np.geomspace(1e-3, 2.0, 60), [2.0],
                        np.linspace(2.0, 60.0, 60)[1:]])
    xt = torch.as_tensor(x, dtype=F64)
    for order in (nu, nu - 1.0):
        np.testing.assert_allclose(special.kv_frac(order, xt).numpy(),
                                   kv(order, x), rtol=1e-10)


def test_sweep_spans_count_the_plans_entries():
    """Under ``tracing()`` every general-nu Matern evaluation of a CPU sweep
    is a ``pymra.cov`` span inside its pass; their ``cov_entries`` add up
    to the plan's blocks times the sets: at each interior level its knots
    against their ancestors' and their own, at each leaf level its (padded)
    locations against their ancestors' knots and their own. A closed-form
    covariance opens none."""
    rng = np.random.default_rng(5)
    locs = rng.random((600, 2))
    y = np.sin(6 * locs[:, 0]) + 0.1 * rng.standard_normal(600)
    model = MRAModel(locs, r=4, M=2, dtype=torch.float32, device="cpu",
                     config=PlanConfig(r=4, M=2, kmeans_impl="native"))
    kern = Kernel("matern", l=torch.tensor([0.05, 0.07], dtype=F64),
                  nu=0.8)
    profiling.clear()
    with profiling.tracing():
        model.sweep(kern, y, 0.01)
    recs = profiling.spans()
    by_id = {r["id"]: r for r in recs}
    cov = [r for r in recs if r["name"] == "pymra.cov"]
    assert cov and all(by_id[r["parent"]]["name"].startswith(
        ("pymra.pass.A", "pymra.pass.B")) for r in cov)
    r, want, blocks = 4, 0, 0
    for m, lvl in enumerate(model.dplan.levels):
        n, (nl, P) = lvl.int_knots.shape[0], lvl.leaf_locs.shape[:2]
        want += n * r * (r + m * r) + nl * P * (P + m * r)
        blocks += (n > 0) * (1 + (m > 0)) + (nl > 0) * (1 + (m > 0))
    assert sum(r["counts"]["cov_entries"] for r in cov) == 2 * want
    assert len(cov) == blocks
    profiling.clear()
    with profiling.tracing():
        model.sweep(Kernel("exponential", l=0.05), y, 0.01)
    assert not [r for r in profiling.spans() if r["name"] == "pymra.cov"]


def test_twin_counts_every_entry_it_evaluates():
    """On the CPU the twin has no table: under ``tracing()`` a general-nu
    Matern's ``pymra.cov`` span counts in ``cov_fallback_entries`` every
    entry times set with s > 0 (the shared point's d = 0 left out), beside
    all of them in ``cov_entries``; an untraced call opens no span."""
    a, b = _points(7)
    l = torch.tensor([0.05, 0.3], dtype=F64).reshape(-1, 1, 1, 1)
    profiling.clear()
    with profiling.tracing(), profiling.trace_annotation("t"):
        kernels.matern(a, b, l=l, sig=1.0, nu=0.8)
    rec = profiling.spans()[-1]
    assert rec["name"] == "pymra.cov"
    d = kernels.dist(a, b)
    assert int((d == 0).sum()) == 1
    assert rec["counts"] == {"cov_entries": 2 * d.numel(),
                             "cov_fallback_entries": 2 * (d.numel() - 1)}
    profiling.clear()
    kernels.matern(a, b, l=l, sig=1.0, nu=0.8)
    assert not profiling.spans()


def test_sweep_counts_the_entries_outside_the_table(on_host, host_library,
                                                   monkeypatch):
    """A traced CPU sweep whose general-nu Matern runs through the host
    build: its ``pymra.cov`` spans' ``cov_fallback_entries`` add up to the
    entries times sets with s > 0 outside [2^-12, 2^10) (points 1e-6 apart
    at l = 0.05, points over 0.81 apart at l = 0.001, and d = 0); an
    untraced sweep hands the kernel no counter."""
    counters = []
    spy = dict(vars(host_library))
    spy["pymra_matern"] = lambda *a: (counters.append(a[7]),
                                      host_library.pymra_matern(*a))[1]
    monkeypatch.setattr(special.build, "load_library",
                        lambda: types.SimpleNamespace(**spy))
    outside = {"below": 0, "above": 0}

    def through_the_kernel(d, l, sig, nu):
        lc = torch.as_tensor(l, dtype=d.dtype).reshape(-1)
        sc = torch.as_tensor(sig, dtype=d.dtype).reshape(-1)
        sc = sc.expand(lc.numel()).contiguous()
        x = math.sqrt(2.0 * nu) * d[None] / lc.reshape((-1,) + (1,) * d.dim())
        outside["below"] += int(((x > 0) & (x < 2.0 ** -12)).sum())
        outside["above"] += int((x >= 2.0 ** 10).sum())
        out = special._matern_launch(None, None,
                                     d.reshape((-1,) + d.shape[-2:]), lc,
                                     sc, nu)
        return out.reshape((lc.numel(),) + d.shape)

    monkeypatch.setattr(kernels, "matern_general", through_the_kernel)
    rng = np.random.default_rng(6)
    locs = rng.random((400, 2))
    locs[200:220] = locs[:20] + 1e-6
    y = np.sin(6 * locs[:, 0]) + 0.1 * rng.standard_normal(400)
    model = MRAModel(locs, r=4, M=2, dtype=F64, device="cpu",
                     config=PlanConfig(r=4, M=2, kmeans_impl="native"))
    kern = Kernel("matern", l=torch.tensor([0.05, 0.001], dtype=F64),
                  nu=0.8)
    profiling.clear()
    with profiling.tracing():
        model.sweep(kern, y, 0.01)
    cov = [r for r in profiling.spans() if r["name"] == "pymra.cov"]
    assert outside["below"] > 0 and outside["above"] > 0
    assert sum(r["counts"]["cov_fallback_entries"] for r in cov) == \
        outside["below"] + outside["above"]
    assert len(counters) == len(cov) and None not in counters
    counters.clear()
    model.sweep(kern, y, 0.01)
    assert counters and counters == [None] * len(counters)


def test_launch_count_sums_every_modules_counters(monkeypatch):
    """The Matern's counters live in ``special``, K1's in ``linalg``: one
    registry sums both, and ``linalg`` reads nothing of ``special``."""
    before = linalg.launch_count()
    assert linalg.launch_count is launch.launch_count
    monkeypatch.setattr(special.matern_cuda, "pullback_launches",
                        special.matern_cuda.pullback_launches + 2)
    monkeypatch.setattr(linalg.leaf_factor, "launches",
                        linalg.leaf_factor.launches + 3)
    assert launch.launch_count() == before + 5
    assert not hasattr(linalg, "special")


def test_pullback_is_a_span_of_its_own(on_host):
    a, b = _points(4)
    lt = torch.tensor([0.05, 0.06], requires_grad=True)
    profiling.clear()
    with profiling.tracing(), profiling.trace_annotation("t"):
        out = on_host(a, b, lt.reshape(-1, 1, 1, 1), 1.0, 0.8)
    out.sum().backward()
    recs = profiling.spans()
    bwd = [r for r in recs if r["name"] == "pymra.bwd.cov"]
    assert len(bwd) == 1 and bwd[0]["launches"] == 1
    assert bwd[0]["call"] == next(r["call"] for r in recs if r["name"] == "t")


def _host_timer(fn, reps=1):
    fn()
    return 1.0


def _no_device_timer(fn, reps=1):
    fn()
    return None, 0.0


def test_chip_smoke_phase_3d_rehearses_on_the_host(on_host, monkeypatch):
    shape = (2, 16, 8, 12)
    rec = chip_smoke.phase_matern_kernel(
        "cpu", shape=shape, timer=_host_timer, dev_timer=_no_device_timer)
    assert rec["forward"]["launches_per_call"] == 1
    assert rec["pullback"]["launches_per_call"] == 1
    assert rec["grad_rel_err"] < 1e-6 and rec["f64_err"] < 1e-6
    assert rec["tables"][0.8]["bytes"] == 14080
    assert rec["tables"][0.8]["max_err"] <= 1e-10
    assert rec["fallback_entries"] > 0
    real = special._matern_pullback

    def dropped(*args):
        gl, gsig = real(*args)
        return gl, 0.5 * gsig

    monkeypatch.setattr(special, "_matern_pullback", dropped)
    with pytest.raises(SystemExit, match="pullback"):
        chip_smoke.phase_matern_kernel(
            "cpu", shape=shape, timer=_host_timer,
            dev_timer=_no_device_timer)


@pytest.mark.parametrize("name, static", [
    ("matern(nu=0.8)", {"nu": 0.8}),
    ("matern( nu = 2.2 )", {"nu": 2.2}),
    ("matern", {}),
])
def test_kernel_name_carries_its_static_parameters(name, static):
    kern = Kernel(name, l=0.3, sig=1.5)
    assert kern.static == static and "(" not in kern.name
    plain = Kernel(kern.name, l=0.3, sig=1.5, **static)
    x = torch.as_tensor(np.random.default_rng(2).random((5, 2)))
    torch.testing.assert_close(kern(x, x), plain(x, x), rtol=0, atol=0)
    assert kern.replace(l=0.4).static == static


@pytest.mark.parametrize("name", ["matern(nu=0.8", "matern(l=0.3)",
                                  "matern(nu)", "matern(nu=0.8, nu=0.9)",
                                  "matern(circular=1)", "matern()"])
def test_kernel_name_refuses_what_is_not_a_smoothness(name):
    with pytest.raises(ValueError):
        Kernel(name, l=0.3)


def test_kernel_name_and_argument_cannot_both_give_nu():
    with pytest.raises(ValueError, match="both"):
        Kernel("matern(nu=0.8)", l=0.3, nu=0.8)


@pytest.mark.parametrize("nu", NUS)
def test_reference_bessel_against_scipy(nu):
    """The benchmark's reference takes K_nu and K_(nu-1) by quadrature, a
    method of its own; scipy holds both to 1e-10."""
    x = np.geomspace(1e-4, 100.0, 97)
    k_nu, k_m1 = mra_matern.bessel_k_pair(nu, torch.as_tensor(x))
    np.testing.assert_allclose(k_nu.numpy(), kv(nu, x), rtol=1e-10)
    np.testing.assert_allclose(k_m1.numpy(), kv(nu - 1.0, x), rtol=1e-10)


#: the cell's configuration at a 44 x 44 grid, 4 knots a node, 3 levels:
#: every node large enough for the frozen planner's rules
TINY = {"side": 44, "missing": 0.1, "features": 64, "l": 0.05, "sig": 1.0,
        "noise_var": 0.01, "nu": 0.8}
TINY_SETS = {"l": np.array([0.05, 0.04, 0.07]),
             "sig": np.array([1.0, 0.9, 1.2])}


@pytest.fixture(scope="module")
def tiny_cell():
    """Data, frozen tree and the reference's answers of the tiny cell."""
    locs, y = matern_field.make(TINY, np.random.SeedSequence(2 ** 31 + 7),
                                "cpu")
    tree = plan_tree(locs, 4, 3, 4, seed=0)
    ref = mra_matern.Reference(tree, y, TINY["noise_var"], jitter=1e-6)
    want = value_and_grad.reference_outputs(ref, TINY_SETS["l"],
                                            TINY_SETS["sig"], 3)
    return locs, y, tree, want


@pytest.mark.parametrize("nu", [0.8, 1.3])
def test_batched_value_and_grad_against_the_reference(tiny_cell, nu):
    """The port's timed path of the cell (``loglik_fn(batched=True)``,
    autograd, the kernel named as the configuration names it) in float64
    on the CPU against the plain reference at nu = 0.8: equal to rounding;
    the port at nu = 1.3 is rejected by far."""
    locs, y, tree, want = tiny_cell
    cfg = {"covariance": f"matern(nu={nu})", "R": TINY["noise_var"],
           "r": 4, "M": 3, "J": 4, "planner_seed": 0, "dtype": "float64",
           "jitter": 1e-6}
    model = harness.build_model(cfg, locs, "cpu")
    assert harness.plan_mismatches(model.plan, tree) == 0
    out = value_and_grad.Runner(model, y, cfg, "cpu").call(TINY_SETS)[2]
    got = [value_and_grad.Runner.pick(out, c) for c in range(3)]
    nums = value_and_grad.compare(got, want)
    if nu == mra_matern.NU:
        assert nums["loglik_abs_err"] < 1e-9 and nums["grad_err"] < 1e-11
    else:
        assert nums["loglik_abs_err"] > 1.0 and nums["grad_err"] > 1e-2


def test_matern_field_is_its_seeds_and_grid_field_at_one_half():
    seed = np.random.SeedSequence(2 ** 33 + 5)
    small = dict(TINY, side=16)
    locs, y = matern_field.make(small, seed, "cpu")
    again = matern_field.make(small, np.random.SeedSequence(2 ** 33 + 5),
                              "cpu")[1]
    other = matern_field.make(small, np.random.SeedSequence(6), "cpu")[1]
    np.testing.assert_array_equal(y, again)
    assert not np.allclose(np.nan_to_num(y), np.nan_to_num(other))
    assert np.isnan(y).any() and np.isfinite(y).sum() > 0.8 * len(y)
    half = matern_field.make(dict(small, nu=0.5),
                             np.random.SeedSequence(3), "cpu")
    plain = grid_field.make(small, np.random.SeedSequence(3), "cpu")
    np.testing.assert_array_equal(half[0], plain[0])
    np.testing.assert_array_equal(half[1], plain[1])


def test_configuration_names_the_references_smoothness():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "grid1m_matern08.json")) as fh:
        cfg = json.load(fh)
    kern = Kernel(cfg["covariance"], l=0.05)
    assert kern.name == "matern" and cfg["reference"] == "mra_matern"
    assert kern.static["nu"] == mra_matern.NU == cfg["data"]["nu"]
