"""Render the per-problem iteration/objective parity table for PARITY.md.

Merges PARITY_REF.json (reference algorithm at f64, tools/parity_study.py)
with a tools/run_maros_mm.py record (osqp_tpu run on the card) into a markdown
table: iterations, polish outcome and objective agreement side by side,
flagging every >2x iteration discrepancy.

Usage: python tools/make_parity_table.py [results/maros.json] [PARITY_REF.json]
Prints markdown to stdout.
"""

from __future__ import annotations

import json
import sys


def main():
    maros_path = sys.argv[1] if len(sys.argv) > 1 else "results/maros.json"
    ref_path = sys.argv[2] if len(sys.argv) > 2 else "PARITY_REF.json"
    maros = json.load(open(maros_path))
    ref = json.load(open(ref_path))
    ref_rows = {r["name"]: r for r in ref["rows"] if "iter" in r}

    print(
        "| Problem | n | m | ref iter | our iter | ratio | ref polish | "
        "our polish | ref rel-obj | our rel-obj |"
    )
    print("|---|---|---|---|---|---|---|---|---|---|")
    flags = 0
    for row in sorted(maros["rows"], key=lambda r: r["name"]):
        name = row["name"]
        rr = ref_rows.get(name)
        if rr is None:
            continue
        it_t = row.get("iter", -1)
        it_r = rr["iter"]
        ratio = it_t / it_r if it_r else float("inf")
        flag = " **>2x**" if ratio > 2.0 or ratio < 0.5 else ""
        if flag:
            flags += 1
        pub = rr.get("published")
        rel_t = (
            abs(row["obj"] - pub) / max(1.0, abs(pub)) if pub is not None else None
        )
        fmt = lambda v: "—" if v is None else f"{v:.1e}"
        print(
            f"| {name} | {row['n']} | {row['m']} | {it_r} | {it_t} | "
            f"{ratio:.2f}{flag} | {rr['status_polish']} | "
            f"{row.get('status_polish', 0)} | {fmt(rr.get('rel_obj_err'))} | "
            f"{fmt(rel_t)} |"
        )
    our_pol = sum(1 for r in maros["rows"] if r.get("status_polish") == 1)
    print(
        f"\nPolish success: reference algorithm {ref['polish_success']}"
        f"/{ref['problems']}, osqp_tpu {our_pol}/{len(maros['rows'])}; "
        f"iteration discrepancies >2x: {flags}."
    )


if __name__ == "__main__":
    main()
