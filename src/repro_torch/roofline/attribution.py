# Port of repro/roofline/attribution.py: top_costs by source, the source
# being the model function on the Python stack and the aten op (or the
# autograd engine's op) where the reference takes the HLO op_name.
"""Cost attribution: where the roofline's bytes, FLOPs and collectives
come from. ``top_costs(cell)`` traces the cell with
``CostMode(attribute=True)`` and ranks its sources per resource."""
from __future__ import annotations


def top_costs(cell, k: int = 25) -> str:
    """Human-readable top-k contributors per resource."""
    trace = cell.trace(attribute=True)
    att = {name: {"bytes": c.bytes, "coll": float(sum(c.coll.values())),
                  "flops": c.flops} for name, c in trace.by_source.items()}
    lines = []
    for res in ("bytes", "coll", "flops"):
        total = sum(v[res] for v in att.values())
        lines.append(f"== top {res} (total {total:.3e}) ==")
        top = sorted(att.items(), key=lambda kv: -kv[1][res])[:k]
        for name, v in top:
            if v[res] <= 0:
                continue
            lines.append(f"  {v[res]:.3e} ({v[res]/max(total,1e-30):6.1%}) "
                         f"{name}")
    return "\n".join(lines)
