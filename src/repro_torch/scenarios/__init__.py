"""Per-neuron population tables (scenarios proper are not ported yet)."""
