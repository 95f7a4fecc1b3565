"""The port's spans and counters (``pymra_torch.utils.profiling``) on the
CPU, on a tiny tree (a 48 x 48 grid, r = 4, M = 3: 64 leaves of 36): off,
they record nothing and change nothing; on, the facade's, the passes', the
levels' and the backward's spans nest, lie on the profiler's clock after
alignment by their anchors, and count the escalated members by kernel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymra_torch import Kernel, MRAModel, PlanConfig
from pymra_torch.ops import linalg
from pymra_torch.tree import sweep as sweep_mod
from pymra_torch.utils import profiling

F32, F64 = torch.float32, torch.float64
SIDE, R, JITTER = 48, 0.01, 1e-6
#: microseconds of slack around an aligned span (the anchor's own width is
#: added)
SLACK_US = 100.0


def _tiny_model():
    xx, yy = np.meshgrid(np.linspace(0, 1, SIDE), np.linspace(0, 1, SIDE))
    locs = np.hstack((xx.reshape(-1, 1), yy.reshape(-1, 1)))
    rng = np.random.default_rng(7)
    y = np.sin(6 * locs[:, 0]) * np.cos(4 * locs[:, 1]) + 0.1 * (
        rng.standard_normal(len(locs)))
    y[rng.random(len(locs)) < 0.1] = np.nan
    model = MRAModel(locs, r=4, M=3, J=4, dtype=F32, jitter=JITTER,
                     device="cpu", config=PlanConfig(r=4, M=3, J=4, seed=0,
                                                     kmeans_impl="numpy"))
    return model, y


@pytest.fixture(scope="module")
def tiny():
    model, y = _tiny_model()
    f = model.loglik_fn(y, R, batched=True, kernel_builder=lambda th: Kernel(
        "exponential", l=th["l"], sig=th["sig"]))
    return model, y, f


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: faster on these tiny tensors, and it leaves the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.clear()
    yield
    profiling.clear()


def _theta():
    return {"l": torch.tensor([0.05, 0.08], dtype=F64, requires_grad=True),
            "sig": torch.tensor([1.0, 1.2], dtype=F64, requires_grad=True)}


def _value_and_grad(f):
    th = _theta()
    v = f(th)
    v.sum().backward()
    return v.detach(), torch.stack([th["l"].grad, th["sig"].grad]), v


def _posterior(model, y):
    kern = Kernel("exponential", l=torch.tensor([0.05, 0.08], dtype=F64),
                  sig=torch.tensor([1.0, 1.2], dtype=F64))
    return model.sweep(kern, y, R)


def _graph_names(t) -> set:
    names, seen, todo = set(), set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(node.name())
        todo += [nxt for nxt, _ in node.next_functions]
    return names


def _call_spans(recs):
    return [r for r in recs if r["call"] is not None]


def test_off_records_nothing_and_changes_nothing(tiny):
    """Off (no profiler, no ``tracing()``): no span but the set-up ones,
    the graph holds no marker, and the value, the gradient and the
    posterior are bit-equal to the sweep called without the facade and to
    a traced run."""
    model, y, f = tiny
    assert not profiling.ON
    val, grad, v = _value_and_grad(f)
    post = _posterior(model, y)
    assert _call_spans(profiling.spans()) == []
    assert "_BoundaryBackward" not in _graph_names(v)

    # the sweep itself, no facade: the same prepared observations
    th = _theta()
    prep = sweep_mod.prepare_obs(model.dplan, y, R)
    raw = sweep_mod.mra_sweep(model.dplan, Kernel(
        "exponential", l=th["l"], sig=th["sig"]), None, None,
        compute_posterior=False, jitter=model.jitter, prep=prep).loglik
    raw.sum().backward()
    assert torch.equal(raw.detach(), val)
    assert torch.equal(torch.stack([th["l"].grad, th["sig"].grad]), grad)

    with profiling.tracing():
        tval, tgrad, tv = _value_and_grad(f)
        tpost = _posterior(model, y)
    assert "_BoundaryBackward" in _graph_names(tv)
    assert torch.equal(tval, val) and torch.equal(tgrad, grad)
    for a, b in zip(post, tpost):
        assert torch.equal(a, b)
    assert len({r["call"] for r in _call_spans(profiling.spans())}) == 2


def _check_nesting(recs):
    by_id = {r["id"]: r for r in recs}
    kids = {}
    for r in recs:
        assert r["end_ns"] is not None, r["name"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["call"] == r["call"]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                p["end_ns"], (r["name"], p["name"])
            kids.setdefault(p["id"], []).append(r)
    for sibs in kids.values():
        sibs = sorted(sibs, key=lambda r: r["start_ns"])
        for a, b in zip(sibs, sibs[1:]):
            assert a["end_ns"] <= b["start_ns"], (a["name"], b["name"])
    return kids


def _names(rs):
    return [r["name"] for r in sorted(rs, key=lambda r: r["start_ns"])]


def test_spans_nest_and_lie_on_the_profilers_clock(tiny):
    """Under a CPU profiler: a value and gradient through ``loglik_fn`` and
    a posterior through ``sweep`` nest call -> passes -> levels (and bwd ->
    bwd.<pass>), under one call id each; a posterior differentiated
    through ``sweep`` (traced with no profiler) adds bwd.D, its backward
    closed at the end of the backward pass; the profiler's only events of
    the program's naming are the empty anchors, one a call; and after
    alignment by them every host operation on a leaf block (P x P) of the
    value-and-gradient call lies in pass B's span, forward or backward."""
    model, y, f = tiny
    P = model.dplan.levels[-1].leaf_locs.shape[1]
    with torch.profiler.profile(record_shapes=True) as prof:
        _value_and_grad(f)
        _posterior(model, y)
    kern = Kernel("exponential",
                  l=torch.tensor([0.05, 0.08], dtype=F64, requires_grad=True),
                  sig=torch.tensor([1.0, 1.2], dtype=F64))
    with profiling.tracing():
        res = model.sweep(kern, y, R)
        (res.loglik.sum() + res.mean.sum() + res.var.sum()).backward()
    recs = profiling.spans()
    calls = sorted({r["call"] for r in _call_spans(recs)})
    assert len(calls) == 3
    grad_recs, post_recs, dpost_recs = (
        [r for r in recs if r["call"] == c] for c in calls)
    post_passes = ["pymra.prep", "pymra.pass.A", "pymra.pass.B",
                   "pymra.pass.C", "pymra.pass.D"]
    for crecs, passes, bwd in (
            (grad_recs, ["pymra.pass.A", "pymra.pass.B", "pymra.pass.C"],
             ["pymra.bwd.C", "pymra.bwd.B", "pymra.bwd.A"]),
            (post_recs, post_passes, None),
            (dpost_recs, post_passes,
             ["pymra.bwd.D", "pymra.bwd.C", "pymra.bwd.B", "pymra.bwd.A"])):
        kids = _check_nesting(crecs)
        roots = sorted((r for r in crecs if r["parent"] is None),
                       key=lambda r: r["start_ns"])
        assert _names(roots) == ["pymra.call"] + (["pymra.bwd"] if bwd
                                                  else [])
        assert _names(kids[roots[0]["id"]]) == passes
        if bwd:
            assert _names(kids[roots[1]["id"]]) == bwd
        for p in kids[roots[0]["id"]]:
            x = p["name"][-1]
            if x in "ABC":
                levels = [c["level"] for c in kids[p["id"]]]
                assert {c["name"] for c in kids[p["id"]]} == {
                    f"pymra.pass.{x}.level"}
                assert levels == sorted(levels, reverse=(x == "C"))
    assert all(r["anchor_ns"] is not None for r in grad_recs + post_recs)
    assert all(r["anchor_ns"] is None for r in dpost_recs)
    assert "pymra.pass.B.level" in profiling.report()

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    ours = [e for e in events if e.name.startswith("pymra")]
    clocks = sorted((e for e in ours if e.name == profiling.CLOCK),
                    key=lambda e: e.time_range.start)
    assert len(clocks) == len(ours) == 2
    for c in clocks:
        assert not any(c.time_range.start < e.time_range.start
                       < c.time_range.end for e in events if e is not c)

    # the value-and-gradient call on the trace's clock
    clock = clocks[0]
    offset = 0.5 * (clock.time_range.start + clock.time_range.end) \
        - grad_recs[0]["anchor_ns"] * 1e-3
    slack = SLACK_US + 0.5 * (clock.time_range.end - clock.time_range.start)

    def span_us(name):
        r, = [r for r in grad_recs if r["name"] == name]
        return (r["start_ns"] * 1e-3 + offset - slack,
                r["end_ns"] * 1e-3 + offset + slack)

    leaf_ops = [e for e in events if e.name.startswith("aten::") and any(
        len(s) >= 2 and list(s[-2:]) == [P, P] for s in e.input_shapes)]
    for outer, inner in (("pymra.call", "pymra.pass.B"),
                         ("pymra.bwd", "pymra.bwd.B")):
        (a, b), (c, d) = span_us(outer), span_us(inner)
        inside = [e for e in leaf_ops if a <= e.time_range.start <= b]
        assert len(inside) > 5, outer
        for e in inside:
            assert c <= e.time_range.start and e.time_range.end <= d, (
                outer, e.name)


def _spd(n, p, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, p, p, generator=g, dtype=F64)
    return (a @ a.transpose(-1, -2) / p + torch.eye(p, dtype=F64)).to(F32)


def _jit(mat):
    return JITTER * (torch.diagonal(mat, dim1=-2, dim2=-1).abs().mean(-1)
                     + 1.0)


def test_escalated_members_are_counted_by_kernel():
    """A float32 batch of five members, two of them indefinite at jitter
    1e-6, through each jittered kernel: its span counts exactly those two
    by kernel (K1: the member whose prior block fails and the one whose
    posterior block alone fails, one each)."""
    mats = {p: _spd(5, p, p) for p in (8, 40, 72)}
    for m in mats.values():
        m[1] -= 3.0 * torch.eye(m.shape[-1])
        m[3, 0, 0] = -1.0
    k_own = mats[40].clone()
    kmask = torch.ones(5, 40)
    a_oo = torch.zeros_like(k_own)
    k_own[3] = _spd(1, 40, 1)[0]
    a_oo[3] = -5.0 * torch.eye(40)  # the posterior block of member 3 only
    with profiling.tracing(), profiling.trace_annotation("escalations"):
        for p in (8, 40, 72):
            sweep_mod._chol(mats[p], JITTER)  # K2, K2, KC
        sweep_mod._chol_logdiag(mats[40], JITTER)  # K6
        _, _, f7 = linalg.cholesky_inv_logdet(mats[40], _jit(mats[40]))
        _, _, _, fp, fq = linalg.leaf_factor(k_own, kmask, a_oo, JITTER)
    (root,) = profiling.spans()
    assert root["name"] == "escalations" and root["parent"] is None
    assert root["escalated_by"] == {"K2": 4, "KC": 2, "K6": 2, "K7": 2,
                                    "K1": 2}
    assert root["escalated"] == 12
    assert (f7 > 1).nonzero().flatten().tolist() == [1, 3]
    assert (fp > 1).nonzero().flatten().tolist() == [1]
    assert (fq > 1).nonzero().flatten().tolist() == [1, 3]
    # off, the same calls keep nothing
    sweep_mod._chol(mats[8], JITTER)
    assert len(profiling.spans()) == 1


def test_setup_spans_record_without_a_profiler():
    model, _ = _tiny_model()
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["pymra.setup.plan",
                                         "pymra.setup.upload"]
    assert all(r["call"] is None and r["host_ms"] > 0 for r in recs)
    # a model given its plan does not plan again
    MRAModel(model.plan.locs, 4, plan=model.plan, dtype=F32, device="cpu")
    assert [r["name"] for r in profiling.spans()][2:] == [
        "pymra.setup.upload"]
