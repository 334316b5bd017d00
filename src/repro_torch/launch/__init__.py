"""Command-line entry points of the ported slices."""
