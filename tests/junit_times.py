"""Seconds per test file from a pytest junit record.

    python tests/junit_times.py run.xml [--top 15]

Prints the session's wall seconds and pass count (tests less errors,
failures and skips, as the suite's runner counts them), the worker-seconds
summed over every test case and over the port's files
(``tests/test_torch_*.py``), then the files by seconds.  Under xdist each
case's time is its own worker's, so the sums are worker-seconds, not wall.
"""
import argparse
import collections
import xml.etree.ElementTree as ET


def file_of(case):
    """``tests/test_x.py`` from a case's ``classname`` (``tests.test_x`` or
    ``tests.test_x.TestClass``)."""
    parts = case.get("classname", "").split(".")
    for i in range(len(parts), 0, -1):
        if parts[i - 1].startswith("test_"):
            return "/".join(parts[:i]) + ".py"
    return case.get("file") or "?"


def summarise(path):
    suite = ET.parse(path).getroot()
    if suite.tag == "testsuites":
        suite = suite.find("testsuite")
    seconds, cases = collections.Counter(), collections.Counter()
    for case in suite.iter("testcase"):
        f = file_of(case)
        seconds[f] += float(case.get("time", 0.0))
        cases[f] += 1
    n = {k: int(suite.get(k, 0)) for k in ("tests", "errors", "failures", "skipped")}
    return dict(
        wall_s=float(suite.get("time", 0.0)),
        n_passed=max(0, n["tests"] - n["errors"] - n["failures"] - n["skipped"]),
        worker_s=sum(seconds.values()),
        port_worker_s=sum(s for f, s in seconds.items() if "/test_torch_" in f),
        files=sorted(((s, cases[f], f) for f, s in seconds.items()), reverse=True),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    r = summarise(args.xml)
    print(f"wall {r['wall_s']:.1f} s, {r['n_passed']} passed, {r['worker_s']:.1f} "
          f"worker-s, port files {r['port_worker_s']:.1f} worker-s")
    for s, n, f in r["files"][:args.top]:
        print(f"{s:9.1f} s {n:5d} cases  {f}")


if __name__ == "__main__":
    main()
