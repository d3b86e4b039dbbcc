"""max|lambda - 1| and the range of b on each level after every coarse step
of chip_smoke's R1 deck with every slice-11c feature on (F1_ALL: all three
fields refluxed, implicit refluxing, the VD correction at etaLambda 0.9,
post-regrid smoothing), cut to a 48x8x8 base with amr.max_dt = 0.12 (the
largest dt of the full-width run; without a cap the coarse base's first
dt from rest blows both packages up, ROADMAP C.20), through the JAX package's
RunDriver and the port's RunDriver on the CPU in float32.  Both runs write
a checkpoint every coarse step, and both are read back with the JAX
package's reader.  Prints one line per step and package.

    python -m tests.torch_jax_lambda_drift [key=value ...]

The arguments are deck keys added to the deck's end (for example
`amr.cfl=0.3`, or `amr.advective_lambda_reflux=0`).  Takes a few minutes
on one CPU core, most of it the JAX step's compile.
"""

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = (48, 8, 8)


def deck(extra=()):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    text = cs.F1_ALL.replace("amr.nx = 128 128 128",
                             "amr.nx = %d %d %d" % NX) \
        .replace("amr.nx_offset = -64 0 0", "amr.nx_offset = -%d 0 0"
                 % (NX[0] // 2)) \
        .replace("plot.plot_interval = 10", "plot.plot_interval = -1") \
        .replace("plot.checkpoint_interval = 10",
                 "plot.checkpoint_interval = 1") + "amr.max_dt = 0.12\n"
    return text + "".join(a.replace("=", " = ", 1) + "\n" for a in extra)


def levels(path, level, fine_grid):
    """[(max|lambda - 1|, min b, max b) of the base, of the patch]."""
    from somar_tpu.io import checkpoint as jck
    got = jck.read_checkpoint(path, level, fine_grid=fine_grid)
    out = []
    for s in (got[0],) + tuple(got[3]):
        lam, b = np.asarray(s.lam), np.asarray(s.scalars)[0]
        out.append((float(np.abs(lam - 1.0).max()), float(b.min()),
                    float(b.max())))
    return out


def run_package(name, text, out_dir):
    if name == "jax":
        from somar_tpu.config.context import ProblemContext
        from somar_tpu.config.parmparse import ParmParse
        from somar_tpu.driver import RunDriver
        drv = RunDriver(ProblemContext.from_parmparse(
            ParmParse.from_string(text)), out_dir=out_dir)
    else:
        from somar_tpu_torch.config.context import ProblemContext
        from somar_tpu_torch.config.parmparse import ParmParse
        from somar_tpu_torch.driver import RunDriver
        drv = RunDriver(ProblemContext.from_parmparse(
            ParmParse.from_string(text)), out_dir=out_dir, device="cpu")
    _, steps = drv.run(verbose=False)
    return steps


def main(argv):
    import jax
    import torch
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    from somar_tpu.config.context import ProblemContext
    from somar_tpu.config.parmparse import ParmParse
    from somar_tpu.driver import RunDriver
    text = deck(argv)
    with tempfile.TemporaryDirectory(prefix="lambda_drift_") as out:
        ref = RunDriver(ProblemContext.from_parmparse(
            ParmParse.from_string(text)), out_dir=os.path.join(out, "ref"))
        fine_grid = [c.ext_grid for c in ref.hierarchy.couplings]
        for name in ("jax", "port"):
            d = os.path.join(out, name)
            os.makedirs(d)
            steps = run_package(name, text, d)
            for i in range(1, steps + 1):
                rows = levels(os.path.join(d, "chkpt_%06d.hdf5" % i),
                              ref.level, fine_grid)
                print(f"{name} step {i}: " + "; ".join(
                    f"level {lev} max|lambda - 1| {lam:.7e} b in "
                    f"[{lo:.7f}, {hi:.7f}]"
                    for lev, (lam, lo, hi) in enumerate(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
