"""The control of the benchmark's check: the reference put in the port's
place, computed one precision below the port's.

The port's DP arithmetic is saturating int16 (int32 where a problem's
scores could pass 32767).  The control is the reference engine built
with its saturating arithmetic clamped at int8's range
(``PORTBENCH_REF_DP=int8``, refmap/native/build.py).  For each seed it
generates the cell's inputs, maps the check's sample on the reference
and on the control, each in a process of its own, and counts the
proteins whose output differs: the number ``correct`` compares, whose
limit is 0.  A control that reads 0 would show the check blind.

    python3 portbench/control.py --workload dm_ag.batch --seeds 1,2,3

Prints one line a seed and, last, a JSON object of the readings.  It
needs no card: the reference runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import check, core, workgen  # noqa: E402


def generate(config: dict, seed: int, workdir: str) -> tuple[str, str]:
    fa = os.path.join(workdir, "genome.fa")
    faa = os.path.join(workdir, "proteome.faa")
    getattr(workgen, config["generator"])(fa, faa, seed=seed % (1 << 63),
                                          **config["generator_args"])
    return fa, faa


def side_blocks(side: str, spec_root: str, workload: str, seed: int,
                fa: str, faa: str) -> dict:
    """The sample's normalised outputs on the reference (``int16``) or
    the control (``int8``), computed in a process of their own."""
    out = os.path.join(os.path.dirname(fa), f"{side}.json")
    env = dict(os.environ, PORTBENCH_REF_DP=side)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--side",
                    side, "--root", spec_root, "--workload", workload,
                    "--seed", str(seed), "--fa", fa, "--faa", faa,
                    "--out", out], env=env, check=True)
    with open(out) as f:
        return json.load(f)


def reading(spec_root: str, workload: str, seed: int) -> dict:
    """The control's reading on one seed: differing proteins of the
    sample, and the seconds each side took."""
    spec = core.load_cell(spec_root, workload)
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        fa, faa = generate(spec["config"], seed, workdir)
        t0 = time.perf_counter()
        ref = side_blocks("int16", spec_root, workload, seed, fa, faa)
        t1 = time.perf_counter()
        ctl = side_blocks("int8", spec_root, workload, seed, fa, faa)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    n_bad, _ = check.count_differing(ref, [ctl])
    return {"seed": seed, "differing": n_bad, "checked": len(ref),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", help="comma-separated seeds")
    ap.add_argument("--root", default=core.ROOT)
    # one side, in its own process (used by reading())
    ap.add_argument("--side", choices=("int16", "int8"))
    ap.add_argument("--seed", type=int)
    ap.add_argument("--fa")
    ap.add_argument("--faa")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.side:
        if os.environ.get("PORTBENCH_REF_DP", "int16") != args.side:
            raise SystemExit("--side must match PORTBENCH_REF_DP")
        spec = core.load_cell(args.root, args.workload)
        prots = check.sample(check.read_fasta(args.faa), spec["traffic"],
                             args.seed)
        blocks = check.reference_blocks(args.fa, prots, spec["config"],
                                        int(spec["config"]["threads"]))
        with open(args.out, "w") as f:
            json.dump(blocks, f)
        return 0
    readings = []
    for s in args.seeds.split(","):
        r = reading(args.root, args.workload, int(s))
        readings.append(r)
        sys.stderr.write(
            f"[control] {args.workload} seed {r['seed']}: {r['differing']} "
            f"of {r['checked']} proteins differ from the reference "
            f"(reference {r['reference_s']:.1f} s, control "
            f"{r['control_s']:.1f} s)\n")
    print(json.dumps({"workload": args.workload, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
