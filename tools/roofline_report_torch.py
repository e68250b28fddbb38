"""Roofline report of the port's dry run: reads the records in
artifacts/dryrun_torch/ (written by `python -m repro_torch.launch.dryrun`)
and prints the per-cell three-term table against the H100 SXM spec, a
prediction for that card (the counterpart of benchmarks/roofline_report.py
for the JAX dry run).

Usage: python3 tools/roofline_report_torch.py [--mesh single|multi] [--tag T]
"""

import argparse
import glob
import json
import os

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "dryrun_torch")


def load_cells(mesh="single", tag=""):
    rows = []
    suffix = f"__{mesh}{('_' + tag) if tag else ''}.json"
    for f in sorted(glob.glob(os.path.join(ART, f"*{suffix}"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def run(mesh="single", tag=""):
    rows = []
    for d in load_cells(mesh, tag):
        if d.get("status") == "skip":
            rows.append({"cell": f"{d['arch']} x {d['shape']}",
                         "status": "SKIP", "note": d["reason"][:60]})
            continue
        if d.get("status") != "ok":
            rows.append({"cell": f"{d['arch']} x {d['shape']}",
                         "status": "FAIL"})
            continue
        r = d["roofline"]
        rows.append({
            "cell": f"{d['arch']} x {d['shape']}",
            "status": "ok",
            "peak_gb": round(d["memory"]["peak_gb"], 1),
            "compute_s": f"{r['compute_s']:.2e}",
            "memory_s": f"{r['memory_s']:.2e}",
            "collective_s": f"{r['collective_s']:.2e}",
            "dominant": r["dominant"],
            "MODEL/counted": round(d["useful_flops_ratio"], 3),
            "MFU_bound": round(r["mfu_upper_bound"], 3),
        })
    return {"table": "roofline", "mesh": mesh, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rep = run(args.mesh, args.tag)
    cols = ["cell", "status", "peak_gb", "compute_s", "memory_s",
            "collective_s", "dominant", "MODEL/counted", "MFU_bound"]
    print("| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rep["rows"]:
        print("| " + " | ".join(str(r.get(c, r.get("note", "")) if c != "cell"
                                    else r[c]) for c in cols) + " |")


if __name__ == "__main__":
    main()
