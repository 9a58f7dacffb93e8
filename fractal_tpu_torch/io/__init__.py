"""Output layer: image encoding and the --open launcher."""
