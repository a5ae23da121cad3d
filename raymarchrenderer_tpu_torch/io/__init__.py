"""Image writers."""
