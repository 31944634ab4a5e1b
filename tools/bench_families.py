"""Produce the Maros-Meszaros-role benchmark record (a JSON file).

Runs the OSQP-paper family suite (osqp_tpu.benchmarks) on the attached
backend, then the QPS fixture corpus (tests/data + tests/data/generated)
through the maros harness, and writes one combined artifact with
per-problem rows and pass rates.

Run on the card:   python tools/bench_families.py --out results/families.json
(first run compiles one program per shape bucket; use nohup for long runs)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("results", "families.json"))
    ap.add_argument("--dims", default="16,32,64,128,256")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fallback", default="float64",
                    help="fallback dtype for failed instances (e.g. float64; "
                         "needs x64 support on the backend)")
    ap.add_argument("--skip-qps", action="store_true")
    args = ap.parse_args()

    import jax

    from osqp_tpu.benchmarks import generate_suite, run_suite

    t0 = time.perf_counter()
    dims = [int(d) for d in args.dims.split(",")]
    problems = generate_suite(dims=dims, instances=args.instances)
    rows, summary = run_suite(
        problems, eps=args.eps, polish=True, dtype=args.dtype,
        fallback_dtype=args.fallback, verbose=True,
    )

    artifact = {
        "device": str(jax.devices()[0].device_kind),
        "eps": args.eps,
        "families": summary,
        "family_rows": rows,
    }

    if not args.skip_qps:
        from osqp_tpu.maros import collect_paths, run_maros

        data_dirs = [
            os.path.join(os.path.dirname(__file__), "..", "tests", "data"),
            os.path.join(
                os.path.dirname(__file__), "..", "tests", "data", "generated"
            ),
        ]
        paths = collect_paths([d for d in data_dirs if os.path.isdir(d)])
        qrows, qsummary = run_maros(
            paths, eps=args.eps, polish=True, dtype=args.dtype,
            fallback_dtype=args.fallback, verbose=True,
        )
        # Check solved objectives against the f64 INDEX where present.
        idx_path = os.path.join(data_dirs[1], "INDEX.json")
        if os.path.exists(idx_path):
            index = json.load(open(idx_path))
            for r in qrows:
                exp = index.get(r["name"])
                if not exp:
                    continue
                if "obj" in exp:
                    ok = (
                        r["status_val"] in (1, 2)
                        and abs(r["obj"] - exp["obj"])
                        <= args.eps * max(1.0, abs(exp["obj"]))
                    )
                else:
                    ok = r["status_val"] == exp["status_val"]
                r["pass"] = bool(ok)
            qsummary["passed_vs_index"] = sum(
                1 for r in qrows if r.get("pass", False)
            )
        artifact["qps"] = qsummary
        artifact["qps_rows"] = qrows

    artifact["total_time"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"\nwrote {args.out} in {artifact['total_time']:.1f}s")
    print(json.dumps({k: v for k, v in artifact.items()
                      if k in ("families", "qps")}, indent=1))


if __name__ == "__main__":
    main()
