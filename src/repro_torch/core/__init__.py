"""DC-ELM core: features, statistics, graphs, mixers, engine, solvers."""
