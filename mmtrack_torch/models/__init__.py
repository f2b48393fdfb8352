"""Models of the port (ViPT, its heads, ResNet-18, Alpha-Refine) and the
flax -> torch weight bridge."""
