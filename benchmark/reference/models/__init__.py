"""Models of the reference."""
