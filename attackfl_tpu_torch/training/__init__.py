"""Round program and simulation engine."""
