"""Graph spec, defaulting, units and the eager compiled-graph executor."""
