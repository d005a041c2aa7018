"""Serving with ahead-of-time solver artifacts.

A serving process should not pay the SymPy frontend and the solver's
set-up in every start. Export the batched solve once (per platform, batch
size, mesh and option set); a serving process loads the artifact and
solves with no ``System`` built and no frontend module imported.

This example exports the README LQR's batch artifact, then starts two
fresh processes, each timed from its first line: one that builds the
system and solves (live), one that loads the artifact and solves
(artifact), each followed by a second solve in the same process (steady
state).

Run: python -m pockit_tpu_torch.examples.serving_aot [batch] [--device cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pockit_tpu_torch.examples.lqr import build
from pockit_tpu_torch.lobatto import constant_guess
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.optimizer.ipm import default_options
from pockit_tpu_torch.utils import save_batch_solver

_SERVE = r"""
import time
t_start = time.perf_counter()
import json, sys
import numpy as np
import torch
kind, artifact, data, device = sys.argv[1:5]
inp = np.load(data)
if kind == "live":
    from pockit_tpu_torch.examples.lqr import build
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer.ipm import default_options
    system, _ = build()
    call = lambda z0, bc: ipm.solve_batch(system, z0, bc_overrides=(bc,),
                                          optimizer_options=default_options(torch.float32),
                                          device=device, dtype=torch.float32)
else:
    from pockit_tpu_torch.utils import load_batch_solver
    call = load_batch_solver(artifact)
times = []
for bc in (inp["bc"], inp["bc2"]):
    res = call(inp["z0"], bc)
    conv = int((res.status == 0).sum())  # a host copy: the solve has ended
    times.append(time.perf_counter() - t_start)
frontend = [m for m in sys.modules if m.startswith(("pockit_tpu_torch.base", "pockit_tpu_torch.lobatto",
                                                    "pockit_tpu_torch.transcription"))]
print(json.dumps(dict(first_result_s=times[0], second_solve_s=times[1] - times[0],
                      converged=conv, frontend_modules=len(frontend))))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    B = args.batch
    system, phase = build()
    x0, _ = preprocess(system, [constant_guess(phase, 0), [0.0]])
    rng = np.random.default_rng(0)
    bc = np.tile(system.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = rng.uniform(0.5, 1.5, B)
    bc2 = bc.copy()
    bc2[:, 0] = rng.uniform(0.5, 1.5, B)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "lqr.aot.zip")
        # -- build box: trace once, ship the artifact ---------------------------
        t0 = time.perf_counter()
        save_batch_solver(artifact, system, B, default_options(torch.float32),
                          device=args.device, dtype=torch.float32)
        print(f"exported {os.path.getsize(artifact) / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s")
        data = os.path.join(tmp, "inputs.npz")
        np.savez(data, z0=np.tile(x0, (B, 1)).astype(np.float32), bc=bc.astype(np.float32),
                 bc2=bc2.astype(np.float32))
        # -- serving boxes: a fresh process each --------------------------------
        out = {}
        for kind in ("live", "artifact"):
            proc = subprocess.run([sys.executable, "-c", _SERVE, kind, artifact, data, args.device],
                                  cwd=root, capture_output=True, text=True, timeout=600, check=True)
            out[kind] = json.loads(proc.stdout.strip().splitlines()[-1])
            r = out[kind]
            print(f"{kind:8s}: first result {r['first_result_s']:.2f} s after start, "
                  f"steady-state solve {r['second_solve_s']:.3f} s, converged {r['converged']}/{B}, "
                  f"frontend modules imported {r['frontend_modules']}")
    return out


if __name__ == "__main__":
    main()
