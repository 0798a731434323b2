# Port of repro/roofline/render.py: the same markdown table, from the
# port's dry-run JSON (temp GB from the trace's temp_peak_bytes).
"""Render the roofline markdown table from dry-run JSON files.

  python -m repro_torch.roofline.render runs/dryrun_torch.json
"""
from __future__ import annotations

import json
import sys


def render(paths):
    rows = []
    for path in paths:
        with open(path) as f:
            recs = json.load(f)
        for key, r in sorted(recs.items()):
            if r["status"] == "skipped":
                rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                            f"skip | — | — | — | — | — | — |")
                continue
            if r["status"] != "ok":
                rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                            f"ERROR | — | — | — | — | — | — |")
                continue
            rf = r["roofline"]
            mem = r.get("memory", {})
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{rf['bottleneck'][:4]} | {rf['t_compute']:.2e} | "
                f"{rf['t_memory']:.2e} | {rf['t_collective']:.2e} | "
                f"{rf['useful_flops_ratio']:.2f} | {rf['mfu_bound']:.4f} | "
                f"{mem.get('temp_peak_bytes', 0)/1e9:.0f} |")
    hdr = ("| arch | shape | mesh | bneck | t_comp (s) | t_mem (s) | "
           "t_coll (s) | useful | mfu_bound | temp GB |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    return hdr + "\n" + "\n".join(rows)


if __name__ == "__main__":
    print(render(sys.argv[1:]))
