"""One module per traffic mode; each defines `Cell`."""
