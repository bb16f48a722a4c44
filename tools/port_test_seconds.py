#!/usr/bin/env python3
"""Test time of the port's CPU test files, for one or more checkouts side by
side.

    python tools/port_test_seconds.py ROOT [ROOT ...] [--rounds 2]
        [--files test_torch_port_trainer.py ...] [--out result.json]

Each ``tests/test_torch_port_*.py`` file of either checkout runs, in each
checkout that has it, in a process of its own (``JAX_PLATFORMS=cpu python
-m pytest FILE -q --durations=0 -p no:cacheprovider -p no:randomly``), and
its test time is the sum of the setup, call and teardown durations pytest
reports. The checkouts take turns
file by file, in the order A B .. B A in every other round, so that a slow
spell of the machine falls on both. Prints one JSON object: per checkout the
sum over files for each round, and per file the times of every round, and
the wall seconds of each file's process.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

_DURATION = re.compile(r"^\s*([0-9.]+)s\s+(setup|call|teardown)\s+\S+")


def file_seconds(root, name):
    """(sum of the reported durations, wall seconds, passed, exit code) of
    one test file run alone in ``root``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    start = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join("tests", name), "-q",
         "--durations=0", "--durations-min=0", "-p", "no:cacheprovider",
         "-p", "no:randomly"],
        cwd=root, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - start
    total = sum(float(m.group(1)) for m in map(_DURATION.match,
                                               out.stdout.splitlines()) if m)
    passed = re.search(r"(\d+) passed", out.stdout)
    return total, wall, int(passed.group(1)) if passed else 0, out.returncode


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--files", nargs="*")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    names = args.files or sorted({
        os.path.basename(p) for root in roots for p in glob.glob(
            os.path.join(root, "tests", "test_torch_port_*.py"))})
    files = {r: {} for r in roots}
    for rnd in range(args.rounds):
        order = roots if rnd % 2 == 0 else roots[::-1]
        for name in names:
            for root in order:
                if not os.path.exists(os.path.join(root, "tests", name)):
                    continue
                total, wall, passed, rc = file_seconds(root, name)
                files[root].setdefault(name, []).append(
                    {"seconds": round(total, 2), "wall": round(wall, 2),
                     "passed": passed, "rc": rc})
                print(json.dumps({"root": root, "file": name, "round": rnd,
                                  "seconds": round(total, 2),
                                  "wall": round(wall, 2), "passed": passed,
                                  "rc": rc}), file=sys.stderr, flush=True)
    result = {root: {
        "sum_seconds": [round(sum(v[i]["seconds"] for v in per.values()), 2)
                        for i in range(args.rounds)],
        "sum_wall": [round(sum(v[i]["wall"] for v in per.values()), 2)
                     for i in range(args.rounds)],
        "passed": [sum(v[i]["passed"] for v in per.values())
                   for i in range(args.rounds)],
        "files": per} for root, per in files.items()}
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
