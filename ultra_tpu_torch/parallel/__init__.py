"""Multi-process runs: the process group, the (data, edge) grid of ranks and
the data-parallel, edge-sharded steps."""
