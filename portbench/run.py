"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 -m portbench.run --workload xray_clahe.archive --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1 also
breakdown; the numbers compared come last, under "check"); the last lines
of standard error give each number compared beside its limit. Without a
card, with fewer cards than the cell asks for, with JAX or the JAX package
loaded, or with a trace whose hand-kernel launches disagree with the
program's counter, it prints no result and exits with a code other than 0.
"""

import time

_T0 = time.perf_counter()  # set-up counts from here: torch's import too

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t0=_T0)
    except harness.NoCard as e:
        print(f"portbench: no run: {e}", file=sys.stderr)
        return 2
    except (harness.TraceMismatch, harness.ForbiddenImport) as e:
        print(f"portbench: run refused: {e}", file=sys.stderr)
        return 1
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
