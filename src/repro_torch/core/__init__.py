"""Engine state, neurons, spikes and Morton codes."""
