"""Models of the port (ViPT, CENTER head) and the flax -> torch weight bridge."""
