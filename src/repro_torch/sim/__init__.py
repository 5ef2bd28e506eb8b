"""Simulation facade, phase context and the phase-implementation registry."""
