#!/usr/bin/env python3
"""Two builds of the block-arrow KKT kernels against each other on one card.

    python3 kernel_ab.py --old-source OLD/pockit_tpu_torch/csrc/block_arrow_kkt.cu \
        [--rounds 3] [--shape 10,16,25] [--batch 16384] [--dtype float32] [--attempts 3]

Builds ``--old-source`` and the checkout's own source with the same flags
(``pockit_tpu_torch/solver/_build.py``) and, at ``--shape`` (nb, ni, nr:
by default the LQR bench shapes, padded to ni_p=16, nr_p=32) in ``--dtype`` (float32 by default)
on ``--batch`` lanes (``chip_smoke.py``'s inputs), with ``--attempts``
Cholesky attempts per block (3 by default: every 7th lane's block 3 is
retried to 1.0). Run it at the bench
shapes and at ``--shape 10,40,25`` (ni_p=40: the run-time interior bodies
of the factor and apply_down, and 400 interior rows for apply_up). Any
shape the kernels take runs: ni up to 64 and nr up to 128 after padding,
for example the 40x10 Radau orbit transfer's ``--shape 40,37,126 --batch
1024`` (both sources must take it). It:

- prints each build's ptxas registers, stack frame and spills per kernel
  (every body, both types);
- checks that the two factor kernels give the same acceptance flags and
  per-block levels and agree per lane within 1e-4 (1e-11 in float64), and
  the two apply_down
  kernels and the two apply_up kernels likewise (each pair on the same
  inputs: the old build's factors and apply_down outputs);
- times the factor, apply_down and apply_up kernels of both with CUDA
  events, in turns (old, new, new, old per round), and prints the times as
  one JSON line, the last.

Each side is run through the port's own wrappers (``cuda_kkt.factor_blocks``,
``cuda_kkt.apply_down`` and ``cuda_kkt.apply_up``) with that side's
library loaded in their place, so both sources must export the same three
C launchers; the factor's and apply_up's launches are read from the
checkout's build alone (``cuda_kkt.factor_launch``, ``apply_up_launch``).
Exits non-zero without a card.
"""

import argparse
import json
import re

import numpy as np

from chip_smoke import CPU_ONLY, cuda_ms, kernel_inputs, max_err, nvidia_smi


def ptxas_summary(log):
    """{kernel<type, built size>: registers, stack frame and spills} from a
    ptxas -v log (the stack and spills of each kernel's own frame; a device
    function it calls has its own properties, which are left out)."""
    out, name, mangled, props = {}, None, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)  # the next stack line is this function's
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kind = next((k for k in ("factor_kernel_wide", "factor_kernel", "apply_down_kernel",
                                     "apply_up_kernel") if k in mangled), None)
            typ = "f64" if ("IdL" in mangled or "IdE" in mangled) else "f32"
            ni = re.search(r"Li(\d+)E", mangled)
            name = f"{kind}<{typ}{', ' + ni.group(1) if ni else ''}>" if kind else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props == mangled:  # not a device function the kernel calls
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source", required=True, help="the other build's .cu file")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of (old, new, new, old)")
    ap.add_argument("--shape", default="10,16,25",
                    help="nb,ni,nr (nb >= 6; ni pads to at most 64, nr to at most 128)")
    ap.add_argument("--batch", type=int, default=16384, help="lanes")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--attempts", type=int, default=3, help="Cholesky attempts per block")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit(CPU_ONLY)
    from pockit_tpu_torch.solver import _build, cuda_kkt as ck

    smi = nvidia_smi()
    print(smi, flush=True)
    libs = {"old": _build.load_source(args.old_source), "new": _build.load_source(_build.SOURCE)}
    ptxas = {}
    for side, src in (("old", args.old_source), ("new", _build.SOURCE)):
        log = (_build.build(src).parent / "ptxas.log").read_text()
        ptxas[side] = ptxas_summary(log)
        print(f"ptxas {side}: {json.dumps(ptxas[side])}", flush=True)

    nb, ni, nr = (int(v) for v in args.shape.split(","))
    if nb < 6 or -(-ni // 8) * 8 > ck.MAX_INTERIOR or -(-nr // 8) * 8 > ck.MAX_REDUCED:
        raise SystemExit(f"--shape {args.shape}: nb >= 6, ni up to {ck.MAX_INTERIOR} and nr up to "
                         f"{ck.MAX_REDUCED} after padding to multiples of 8")
    B, dtype = args.batch, getattr(torch, args.dtype)
    core = ck.make_core(np.arange(nb * ni).reshape(nb, ni), np.arange(nb * ni, nb * ni + nr),
                        nb * ni + nr)
    _build._lib = libs["new"]
    factor_launch = ck.factor_launch(core.ni_p, core.nr_p, B, dtype)
    Kt, b_i, b_r = kernel_inputs(core, B, dtype, seed=7, device="cuda", nb=nb, ni=ni, nr=nr)
    kw = dict(ni_real=ni, nr_real=nr, pivot_rtol=2.0 * float(np.sqrt(np.finfo(np.float32).eps)),
              delta_floor=0.1, attempts=args.attempts)
    delta = torch.zeros(Kt[0].shape[-1], dtype=dtype, device="cuda")

    def factor(side):
        _build._lib = libs[side]  # the wrappers launch what load() returns
        return ck.factor_blocks(*Kt, delta, **kw)

    # the new side first: the wrapper reads the body it counts a launch under
    # from the library that launches first at a shape
    fac = {s: factor(s) for s in ("new", "old")}

    def apply_down(side):
        _build._lib = libs[side]
        return ck.apply_down(fac["old"][0], fac["old"][1], Kt[1], b_i, b_r)

    down = {s: apply_down(s) for s in ("old", "new")}

    def apply_up(side):
        _build._lib = libs[side]
        L_r, sc_r, X_ir = fac["old"][3], fac["old"][4], fac["old"][2]
        return ck.apply_up(L_r, sc_r, down["old"][1], X_ir, down["old"][0])

    up = {s: apply_up(s) for s in ("old", "new")}
    torch.cuda.synchronize()
    ok = fac["old"][5][3, :B] > 0.5
    if not torch.equal(ok, fac["new"][5][3, :B] > 0.5) or not torch.equal(fac["old"][6],
                                                                           fac["new"][6]):
        raise AssertionError("old and new factor kernels differ in flags or levels")
    lanes = torch.nonzero(ok)[:, 0].cpu()
    rel = {
        "factor": max(max_err(a.cpu()[..., lanes], b.cpu()[..., lanes])[1]
                      for a, b in zip(fac["new"], fac["old"])),
        "apply_down": max(max_err(a.cpu()[..., lanes], b.cpu()[..., lanes])[1]
                          for a, b in zip(down["new"], down["old"])),
        "apply_up": max(max_err(a.cpu()[..., lanes], b.cpu()[..., lanes])[1]
                        for a, b in zip(up["new"], up["old"])),
    }
    print(f"new against old, per-lane relative: {rel}", flush=True)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    if max(rel.values()) > tol:
        raise AssertionError(f"old and new kernels disagree above {tol:.0e} per lane")

    times = {f"{k}_{s}": [] for k in ("factor", "apply_down", "apply_up") for s in ("old", "new")}
    for _ in range(args.rounds):
        for side in ("old", "new", "new", "old"):
            times[f"factor_{side}"].append(cuda_ms(lambda: factor(side), 20))
            times[f"apply_down_{side}"].append(cuda_ms(lambda: apply_down(side), 50))
            times[f"apply_up_{side}"].append(cuda_ms(lambda: apply_up(side), 50))
    med = {k: float(np.median(v)) for k, v in times.items()}
    _build._lib = libs["new"]  # the launch the new build makes
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi,
                      "shape": {"nb": nb, "ni_p": core.ni_p, "nr_p": core.nr_p, "lanes": B},
                      "dtype": args.dtype, "factor_launch": factor_launch,
                      "apply_up_launch": ck.apply_up_launch(nb, core.ni_p, core.nr_p, B, dtype),
                      "median_ms": med, "ms": times, "lane_rel_err_new_vs_old": rel,
                      "ptxas": ptxas}), flush=True)


if __name__ == "__main__":
    main()
