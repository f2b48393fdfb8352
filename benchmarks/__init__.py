"""The benchmark of mmtrack_torch: one cell per run (`python3 -m benchmarks.run`)."""
