"""decode_graph_share: the port's ``serve.step`` spans in the traced
batches that hold a ``decode.graph`` span (a step replayed from CUDA
graphs) over all of them, in %: 0 where the program replays no step,
nothing where it records no span."""
from bench import spans


def read(ctx):
    records = spans.program_spans(ctx.trace)
    steps = {r.id for r in records if r.name == "serve.step"}
    if not steps:
        return None
    byid = {r.id: r for r in records}
    held = set()
    for r in records:
        if r.name != "decode.graph":
            continue
        up = r.parent
        while up is not None and up not in steps and up in byid:
            up = byid[up].parent
        if up in steps:
            held.add(up)
    return 100.0 * len(held) / len(steps)
