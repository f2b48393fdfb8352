"""Tools that set the benchmark up: readings for its limits."""
