"""Seconds per build spent walking and consolidating into ELL rows, the
mean of ``preprocess_graph``'s ``walk_consolidate_s`` over the window."""
LAYER = "preprocessing"
UNIT = "s"
SOURCE = "program_span"
MOVES = "features_s"


def read(ctx):
    builds = ctx["probes"].captures.get("builds", [])
    return sum(b["walk_consolidate_s"] for b in builds) / len(builds) if builds else None
