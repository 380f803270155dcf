"""The tier-1 test run's clock: its seconds, passes, CPU-seconds and each
test file's worker seconds (the sum of its tests' times in the junit XML),
the port's files (``tests/test_torch_*.py``) apart.

    python3 scripts/tier1_clock.py              # run ROADMAP.md's tier-1 command here
    python3 scripts/tier1_clock.py --junit X    # summarise the junit XML of an earlier run

The run is ROADMAP.md's "Tier-1 verify" command (6 xdist workers, files
handed out whole, a 1470 s limit) with its log and junit XML under
``build/``. Its CPU-seconds are the user and system time of the pytest
process and every process it started and waited for. Time it with
``.jax_cache/`` moved away, as a fresh checkout has none.
"""

import argparse
import collections
import os
import resource
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PYTEST = ["-m", "pytest", "tests/", "-q", "-m", "not slow", "--continue-on-collection-errors",
          "-p", "no:cacheprovider", "-p", "xdist", "-n", "6", "--dist", "loadfile",
          "-p", "no:randomly"]


def summarise(junit):
    """Print the per-file worker seconds and the totals of a junit XML."""
    suite = ET.parse(junit).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    seconds, tests = collections.Counter(), collections.Counter()
    for case in suite.iter("testcase"):
        name = case.get("classname").split(".")[1]
        seconds[name] += float(case.get("time"))
        tests[name] += 1
    for name, s in sorted(seconds.items(), key=lambda kv: -kv[1]):
        print(f"{name:36s} {tests[name]:4d} tests {s:9.1f} s")
    port = sum(s for name, s in seconds.items() if name.startswith("test_torch_"))
    bad = sum(int(suite.get(k)) for k in ("errors", "failures", "skipped"))
    print(f"passed {int(suite.get('tests')) - bad} of {suite.get('tests')}; worker seconds: "
          f"all files {sum(seconds.values()):.1f}, the port's {port:.1f}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--junit", help="summarise this junit XML instead of running the tests")
    args = parser.parse_args()
    if args.junit:
        summarise(args.junit)
        return
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    junit, log = out / "tier1.xml", out / "tier1.log"
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    t0 = time.time()
    with open(log, "w") as f:
        try:
            rc = subprocess.run(["timeout", "-k", "10", "1470", sys.executable, *PYTEST,
                                 f"--junitxml={junit}"], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT).returncode
        finally:
            seconds = time.time() - t0
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"exit {rc} after {seconds:.1f} s; CPU-seconds {usage.ru_utime + usage.ru_stime:.1f} "
          f"(user {usage.ru_utime:.1f}), {(usage.ru_utime + usage.ru_stime) / seconds:.2f} "
          f"cores on average; log {log}")
    summarise(junit)


if __name__ == "__main__":
    main()
