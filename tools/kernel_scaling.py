#!/usr/bin/env python3
"""How K1 ``leaf_factor``, K4 ``cholesky`` and K3 ``triangular_inverse_lower``
scale with the width and the batch on the card: a profile by experiment,
for cards where no hardware profiler runs.

Times each kernel (CUDA events over 10 calls after a warm-up, as
``chip_smoke.time_ms``) on ``chip_smoke``'s test matrices at B = 16384 and
P in 16, 32, 48, 64, and at P = 64 for B from 1024 to 32768; and K3 at its
wide widths (``tri_inv_wide.cu``, P in 65..256 at B = 4096, and at P = 256
for B from 256 to 8192). A kernel bound by its arithmetic grows as P^3
and linearly in B; one bound by the latency of its serial column steps
grows as the number of steps and stays flat in B until the card is full. Prints one line per shape, the fitted
exponents, the per-member time and the rate of useful float32 operations
(``chip_smoke.work``), and with ``--out`` writes them as JSON. Run from the
root of the tree to time on a machine with an NVIDIA GPU::

    python3 tools/kernel_scaling.py [--out FILE] [--quick | --logdet |
                                     --solve | --jittered | --pullback]

``--quick`` times P = 64, B = 16384 and K3 at 4096 x 256 only.
``--logdet`` times K6 ``cholesky_logdet`` and K7 ``cholesky_inv_logdet``
instead, with their library calls (``chip_smoke.LIBRARY``) and K3, on
clean batches (``chip_smoke.clean_case``: one attempt a member) at the
dense-R path's B = 256 for P from 8 to 64, per call and on the device
alone (``chip_smoke.device_ms``): there a launch lasts one member's chain
of P steps, so device ms / P is the time of one step (a call at that
batch is mostly the host's).
``--solve`` times K5 ``solve_triangular_batched`` at
``chip_smoke.SOLVE_MAIN`` (beside ``torch.linalg.solve_triangular``) and
the fused ``cholesky_pullback`` at every shape of
``chip_smoke.PULLBACK_MAIN``, per call and on the device alone (the
pullback over ``chip_smoke.PULLBACK_DEVICE_REPS`` launches a profile), on
the inputs of phases 3 and 3b.
``--jittered`` times K2 ``cholesky_jittered`` at ``chip_smoke.CHOL_MAIN``
and ``chip_smoke.CHOL_SIDE``, on the clean batch beside its library call
(``chip_smoke.LIBRARY``) and on ``chip_smoke.chol_case`` (escalated and
all-fail members), and its backward, the fused ``cholesky_pullback``, at
``CHOL_SIDE`` on phase 3b's inputs, per call and on the device alone.
``--pullback`` times the fused ``cholesky_pullback`` at the widths of its
9 <= P <= 64 route (``PULLBACK_WIDTHS``) at the triangular route's batches
B = 256 and 16384 (N=10^4 and N=10^6), on phase 3b's inputs: ms a call,
device ms over ``chip_smoke.PULLBACK_DEVICE_REPS`` launches, the share of
the bound (``chip_smoke.work``) the device time reaches, and the kernel's
registers a thread and shared memory (``cuobjdump -res-usage`` of the
built library) with the blocks an SM they allow (``occupancy``).

The kernels timed are the package of the working directory's tree;
``chip_smoke``'s helpers are those of the tree this tool lies in, so the
tool of a newer tree can time an older one on the same card: run it from
the older tree's root as ``python3 NEWER/tools/kernel_scaling.py``.
"""
import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# chip_smoke imports the package only when a phase runs: from here on,
# the working directory's
sys.path.insert(0, os.getcwd())

WIDTHS = (16, 32, 48, 64)
BATCHES = (1024, 2048, 4096, 8192, 16384, 32768)
MAIN_B = 16384
NAMES = ("leaf_factor", "cholesky", "triangular_inverse_lower")
#: K3's wide kernel: its widths at the M=6 batch, and batches at P = 256
WIDE_B = 4096
WIDE_WIDTHS = (65, 96, 128, 169, 192, 256)
WIDE_BATCHES = (256, 512, 1024, 2048, 4096, 8192)


def _cases(rng, b, p):
    """K1's, K4's and K3's inputs on the card at (b, p)."""
    import torch

    leaf = [torch.as_tensor(x, device="cuda")
            for x in cs.leaf_case(rng, b, p, escalate=True)]
    chol = torch.as_tensor(cs.chol_case(rng, b, p)[0], device="cuda")
    low = torch.as_tensor(cs.lower_case(rng, b, p), device="cuda")
    return leaf, chol, low


def _time(b, p, leaf, chol=None, low=None):
    from pymra_torch.ops import linalg as tl

    runs = []
    if leaf is not None:
        c, k, a = leaf
        runs.append(("leaf_factor", lambda: tl.leaf_factor(c, k, a, 1e-3),
                     leaf, list(tl.leaf_factor(c, k, a, 1e-3))))
    if chol is not None:
        runs.append(("cholesky", lambda: tl.cholesky(chol), [chol],
                     [tl.cholesky(chol)]))
    if low is not None:
        runs.append(("triangular_inverse_lower",
                     lambda: tl.triangular_inverse_lower(low), [low],
                     [tl.triangular_inverse_lower(low)]))
    row = {}
    for name, run, inputs, outs in runs:
        ms = cs.time_ms(run)
        _, flops, _ = cs.work(name, inputs, outs)
        row[name] = {"ms": ms, "us_per_member": ms * 1e3 / b,
                     "gflop_per_s": flops / ms / 1e6}
        print(f"{name} B={b} P={p}: {ms:.4f} ms, "
              f"{ms * 1e6 / b:.1f} ns a member, "
              f"{flops / ms / 1e6:.0f} GFLOP/s useful", flush=True)
    return row


#: K6 and K7 at the dense-R batch, over P
LOGDET_B = 256
LOGDET_WIDTHS = (8, 16, 24, 32, 40, 49, 56, 64)


def _time_logdet(rng, device="cuda", widths=LOGDET_WIDTHS):
    """K6, K7, their library calls and K3 at LOGDET_B over ``widths``: ms
    a call, device ms and microseconds a step (device ms / P; None where
    the device time was not measured)."""
    import torch

    from pymra_torch.ops import linalg as tl

    res = {}
    for p in widths:
        m, jit = (torch.as_tensor(x, device=device)
                  for x in cs.clean_case(rng, LOGDET_B, p))
        eye = torch.eye(p, device=device)
        low = tl.cholesky(m + jit[:, None, None] * eye)
        runs = {"triangular_inverse_lower":
                lambda: tl.triangular_inverse_lower(low)}
        for name in ("cholesky_logdet", "cholesky_inv_logdet"):
            fn, lib = getattr(tl, name), cs.LIBRARY[name]
            runs[name] = lambda fn=fn: fn(m, jit)
            runs[name + "_library"] = lambda lib=lib: lib(m, jit, eye)
        res[p] = {}
        for name, run in runs.items():
            ms = cs.time_ms(run)
            dev, launches = cs.device_ms(run)
            step = None if dev is None else dev * 1e3 / p
            res[p][name] = {"ms": ms, "device_ms": dev,
                            "device_launches": launches,
                            "us_per_step": step}
            print(f"{name} B={LOGDET_B} P={p}: {ms:.4f} ms a call, device "
                  f"{cs._ms(dev)} ({launches:g} launches), "
                  f"{'n/m' if step is None else f'{step:.3f}'} us a step",
                  flush=True)
    for name in res[widths[0]]:
        dev_p = [res[p][name]["device_ms"] for p in widths]
        if None not in dev_p:
            print(f"{name}: device time ~ P^{_slope(widths, dev_p):.2f} "
                  f"at B={LOGDET_B}")
    return res


def _run(tag, fn, reps=10):
    """ms a call, device ms and launches a call of ``fn``, printed."""
    ms = cs.time_ms(fn)
    dev, launches = cs.device_ms(fn, reps)
    print(f"{tag}: {ms:.4f} ms a call, device {cs._ms(dev)} "
          f"({launches:g} launches)", flush=True)
    return {"ms": ms, "device_ms": dev, "device_launches": launches}


def _pullback_inputs(rng, b, p, device):
    """Phase 3b's pullback inputs: K2's factors of ``chol_case`` and
    random cotangents."""
    import torch

    from pymra_torch.ops import linalg as tl

    m, jit = cs.chol_case(rng, b, p)
    l, _, f = tl.cholesky_jittered(torch.as_tensor(m, device=device),
                                   torch.as_tensor(jit, device=device))
    lbar = torch.as_tensor(rng.standard_normal(m.shape).astype(np.float32),
                           device=device)
    ldbar = torch.as_tensor(rng.standard_normal(b).astype(np.float32),
                            device=device)
    return l, lbar, ldbar, f


def _time_jittered(rng, device="cuda"):
    """K2 at ``cs.CHOL_MAIN`` and ``cs.CHOL_SIDE`` on the clean batch (with
    its library call) and on ``chol_case``, and the pullback at
    ``cs.CHOL_SIDE``: ms a call, device ms and launches a call."""
    import torch

    from pymra_torch.ops import linalg as tl

    res = {}
    for b, p in tuple(cs.CHOL_MAIN) + tuple(cs.CHOL_SIDE):
        key = f"{b}x{p}x{p}"
        eye = torch.eye(p, device=device)
        m, jit = (torch.as_tensor(x, device=device)
                  for x in cs.clean_case(rng, b, p))
        res[f"cholesky_jittered clean {key}"] = _run(
            f"cholesky_jittered clean {key}",
            lambda: tl.cholesky_jittered(m, jit))
        res[f"library clean {key}"] = _run(
            f"library clean {key}", lambda: cs._library_factor(m, jit, eye))
        m, jit = (torch.as_tensor(x, device=device)
                  for x in cs.chol_case(rng, b, p))
        res[f"cholesky_jittered chol_case {key}"] = _run(
            f"cholesky_jittered chol_case {key}",
            lambda: tl.cholesky_jittered(m, jit))
    for b, p in cs.CHOL_SIDE:
        args = _pullback_inputs(rng, b, p, device)
        res[f"cholesky_pullback {b}x{p}x{p}"] = _run(
            f"cholesky_pullback {b}x{p}x{p}",
            lambda: tl.cholesky_pullback(*args), cs.PULLBACK_DEVICE_REPS)
    return res


def _time_solve(rng, device="cuda"):
    """K5 at ``cs.SOLVE_MAIN`` with its library call, and the pullback at
    ``cs.PULLBACK_MAIN``: ms a call, device ms and launches a call."""
    import torch

    from pymra_torch.ops import linalg as tl

    res = {}
    for b, p, q, trans in cs.SOLVE_MAIN:
        lt = torch.as_tensor(cs.lower_case(rng, b, p), device=device)
        rhs = torch.as_tensor(rng.standard_normal((b, p, q)).astype(
            np.float32), device=device)
        op_l = lt.transpose(-1, -2) if trans else lt
        key = f"{b}x{p}x{q}{' transposed' if trans else ''}"
        res["solve_triangular_batched " + key] = _run(
            f"solve_triangular_batched {key}",
            lambda: tl.solve_triangular_batched(lt, rhs, trans))
        res["solve_triangular " + key] = _run(
            f"torch.linalg.solve_triangular {key}",
            lambda: torch.linalg.solve_triangular(op_l, rhs, upper=trans))
    for b, p in cs.PULLBACK_MAIN:
        args = _pullback_inputs(rng, b, p, device)
        res[f"cholesky_pullback {b}x{p}x{p}"] = _run(
            f"cholesky_pullback {b}x{p}x{p}",
            lambda: tl.cholesky_pullback(*args), cs.PULLBACK_DEVICE_REPS)
    return res


#: KP's widths above P = 8 (the tiers' edges and the paths' 49 and 64) and
#: the triangular route's leaf batches
PULLBACK_WIDTHS = (9, 16, 17, 32, 33, 48, 49, 64)
PULLBACK_BATCHES = (256, 16384)
#: Hopper (sm_90) per SM: registers (allocated to a warp in units of 256),
#: shared memory and the part of it each block reserves (bytes), blocks
#: and warps
SM_REGS, SM_SMEM, BLOCK_RESERVED, SM_BLOCKS, SM_WARPS = (
    65536, 233472, 1024, 32, 64)
USAGE_RE = re.compile(r"Function (\S+):\s*REG:(\d+)\s+STACK:(\d+)\s+"
                      r"SHARED:(\d+)\s+LOCAL:(\d+)")


def occupancy(regs: int, smem: int, threads: int = 64) -> int:
    """Blocks an SM of ``threads`` threads with ``regs`` registers a
    thread and ``smem`` bytes of shared memory (static and dynamic), by the
    occupancy rules of sm_90."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = min(SM_REGS // per_warp, SM_WARPS) // warps if regs else \
        SM_BLOCKS
    by_smem = SM_SMEM // (smem + BLOCK_RESERVED)
    return min(SM_BLOCKS, SM_WARPS // warps, by_regs, by_smem)


def resource_usage(lib_glob: str) -> dict:
    """``{mangled kernel name: {"regs", "stack", "shared", "local"}}`` of
    the newest built library matching ``lib_glob`` in the timed package's
    build directory, from ``cuobjdump -res-usage``; empty where the tool or
    the library is missing."""
    import glob
    import subprocess

    from pymra_torch.ops import BUILD_DIR
    from pymra_torch.ops.cuda import build

    libs = sorted(glob.glob(os.path.join(BUILD_DIR, lib_glob)),
                  key=os.path.getmtime)
    if not libs:
        return {}
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    res = subprocess.run([tool, "-res-usage", libs[-1]], capture_output=True,
                         text=True, timeout=120)
    return {m[1]: dict(zip(("regs", "stack", "shared", "local"),
                           map(int, m.groups()[1:])))
            for m in USAGE_RE.finditer(res.stdout)}


def _pullback_kernel(usage: dict, p: int):
    """(name, usage, dynamic shared bytes) of the kernel the pullback
    launches at 9 <= P <= 64 in the timed tree: the core's pullback mode
    at the tier's NB, or the thread-per-column kernel it replaced."""
    from pymra_torch.ops import linalg as tl

    nb = tl.tile_tier(p) // 8
    for key, use in usage.items():
        if f"chol_pullback_tileILi{nb}E" in key:
            return f"chol_pullback_tile<{nb}>", use, 0
    for key, use in usage.items():
        if "chol_pullback_block" in key:
            return "chol_pullback_block", use, 2 * p * (p | 1) * 4
    return None, None, 0


def _time_pullback(rng, device="cuda", widths=PULLBACK_WIDTHS,
                   batches=PULLBACK_BATCHES):
    """The pullback at ``widths`` x ``batches``: ms a call, device ms,
    launches a call, the bound and the device time's share of it, and the
    kernel's registers, shared memory and blocks an SM."""
    from pymra_torch.ops import linalg as tl

    usage = resource_usage("libpymra_tri_solve_*.so")
    res = {}
    for b in batches:
        for p in widths:
            key = f"cholesky_pullback {b}x{p}x{p}"
            args = _pullback_inputs(rng, b, p, device)
            row = _run(key, lambda: tl.cholesky_pullback(*args),
                       cs.PULLBACK_DEVICE_REPS)
            b_ms, b_by = cs.bound_ms(*cs.work(
                "cholesky_pullback", list(args),
                list(tl.cholesky_pullback(*args))))
            dev = row["device_ms"]
            name, use, dyn = _pullback_kernel(usage, p)
            row.update(bound_ms=b_ms, bound_by=b_by,
                       device_bound_share=None if dev is None else b_ms / dev,
                       kernel=name)
            if use is not None:
                row.update(regs=use["regs"], local_bytes=use["local"],
                           shared_bytes=use["shared"] + dyn,
                           blocks_per_sm=occupancy(use["regs"],
                                                   use["shared"] + dyn))
            res[key] = row
            print(f"  bound {b_ms:.4f} ms ({b_by}), "
                  f"{'n/m' if dev is None else f'{100 * b_ms / dev:.1f}%'}"
                  f" of the device time; {name}: "
                  + ("usage not measured" if use is None else
                     f"{use['regs']} registers a thread, {use['local']} "
                     f"bytes local, {use['shared'] + dyn} bytes shared, "
                     f"{row['blocks_per_sm']} blocks an SM"), flush=True)
    return res


def _wide_case(rng, b, p):
    import torch

    return torch.as_tensor(cs.lower_case(rng, b, p), device="cuda")


def _slope(xs, ys):
    return float(np.polyfit(np.log(xs), np.log(ys), 1)[0])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--logdet", action="store_true")
    parser.add_argument("--solve", action="store_true")
    parser.add_argument("--jittered", action="store_true")
    parser.add_argument("--pullback", action="store_true")
    args = parser.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    rng = np.random.default_rng(0)
    res = {"card": card, "widths": {}, "batches": {}}
    if args.logdet:
        _report({"card": card, "logdet": _time_logdet(rng)}, args.out)
        return
    if args.solve:
        _report({"card": card, "solve": _time_solve(rng)}, args.out)
        return
    if args.jittered:
        _report({"card": card, "jittered": _time_jittered(rng)}, args.out)
        return
    if args.pullback:
        _report({"card": card, "pullback": _time_pullback(rng)}, args.out)
        return
    if args.quick:
        _time(MAIN_B, 64, *_cases(rng, MAIN_B, 64))
        _time(WIDE_B, 256, None, low=_wide_case(rng, WIDE_B, 256))
        return
    for p in WIDTHS:
        res["widths"][p] = _time(MAIN_B, p, *_cases(rng, MAIN_B, p))
    leaf, chol, low = _cases(rng, max(BATCHES), 64)
    for b in BATCHES:
        res["batches"][b] = _time(b, 64, [x[:b] for x in leaf], chol[:b],
                                  low[:b])
    del leaf, chol, low
    res["wide_widths"] = {p: _time(WIDE_B, p, None,
                                   low=_wide_case(rng, WIDE_B, p))
                          for p in WIDE_WIDTHS}
    low = _wide_case(rng, max(WIDE_BATCHES), 256)
    res["wide_batches"] = {b: _time(b, 256, None, low=low[:b])
                           for b in WIDE_BATCHES}
    ms_p = [res["wide_widths"][p]["triangular_inverse_lower"]["ms"]
            for p in WIDE_WIDTHS]
    ms_b = [res["wide_batches"][b]["triangular_inverse_lower"]["ms"]
            for b in WIDE_BATCHES]
    res["wide_exponent_in_p"] = _slope(WIDE_WIDTHS, ms_p)
    res["wide_exponent_in_b"] = _slope(WIDE_BATCHES[2:], ms_b[2:])
    print(f"triangular_inverse_lower (wide): time ~ "
          f"P^{res['wide_exponent_in_p']:.2f} at B={WIDE_B}, ~ "
          f"B^{res['wide_exponent_in_b']:.2f} for B >= {WIDE_BATCHES[2]} "
          "at P=256")
    for name in NAMES:
        ms_p = [res["widths"][p][name]["ms"] for p in WIDTHS]
        ms_b = [res["batches"][b][name]["ms"] for b in BATCHES]
        res[f"{name}_exponent_in_p"] = _slope(WIDTHS, ms_p)
        res[f"{name}_exponent_in_b"] = _slope(BATCHES[2:], ms_b[2:])
        print(f"{name}: time ~ P^{res[f'{name}_exponent_in_p']:.2f} at "
              f"B={MAIN_B}, ~ B^{res[f'{name}_exponent_in_b']:.2f} for B >= "
              f"{BATCHES[2]} at P=64")
    _report(res, args.out)


def _report(res, out):
    print(json.dumps(res))
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
