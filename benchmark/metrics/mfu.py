"""``mfu.<cell kind>``: the model's operations for the work the traced
window completed, over the window times the card's float32 peak (the
configurations compute in float32 with TF32 off, outside the tensor
cores). The operations are ``data/flops.py``'s: the driver's count of
relation queries and of entity queries (a query a projection, for
UltraQuery) times one query's operations on the cell's graphs."""

from benchmark.data.bounds import H100_F32_FLOPS
from benchmark.data.flops import entity_query_flops, relation_query_flops


def read(ctx):
    ent, rel = ctx.graphs["entity"], ctx.graphs["relation"]
    ops = (ctx.work["relation_queries"] * relation_query_flops(ctx.config, rel["nodes"],
                                                                rel["edges"])
           + ctx.work["entity_queries"] * entity_query_flops(ctx.config, ent["nodes"],
                                                              ent["edges"], ent["relations"]))
    if not ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ops / (ctx.trace.window_s * H100_F32_FLOPS)
