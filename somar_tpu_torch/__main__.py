"""The command line of the port, the counterpart of the JAX package's
`somar.py`:

    python -m somar_tpu_torch [--device cpu] <input_file> [key=value ...]

Reads an input file in the reference's format, applies the key=value
overrides, and runs it through RunDriver (one level, or with
amr.maxlevel = 1 a two-level AMR hierarchy), writing plot and checkpoint
files into the current directory.  The run is on the
GPU unless --device says otherwise.
"""

import sys


def main(argv) -> int:
    args = list(argv[1:])
    device = "cuda"
    if args[:1] == ["--device"] and len(args) >= 2:
        device = args[1]
        args = args[2:]
    elif args and args[0].startswith("--device="):
        device = args[0].split("=", 1)[1]
        args = args[1:]
    if not args:
        print(__doc__)
        return 1
    in_file, overrides = args[0], args[1:]

    from somar_tpu_torch.config.context import ProblemContext
    from somar_tpu_torch.driver import RunDriver

    ctx = ProblemContext.from_file(in_file, overrides)
    state, steps = RunDriver(ctx, device=device).run()
    print(f"finished {steps} steps at t = {float(state.time):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
