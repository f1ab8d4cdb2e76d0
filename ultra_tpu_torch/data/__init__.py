"""Knowledge-graph data: synthetic graphs and splits."""
