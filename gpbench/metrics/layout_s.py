"""Seconds per build spent on the layout after consolidation: the offset
scan and K3 (``stencil_build_s``), or the offset scan and the column-sorted
transpose (``vocabulary_s`` + ``transpose_s``): every other phase
``preprocess_graph`` times, mean over the window."""
LAYER = "preprocessing"
UNIT = "s"
SOURCE = "program_span"
MOVES = "features_s"


def read(ctx):
    builds = ctx["probes"].captures.get("builds", [])
    if not builds:
        return None
    return sum(sum(v for k, v in b.items() if k != "walk_consolidate_s")
               for b in builds) / len(builds)
