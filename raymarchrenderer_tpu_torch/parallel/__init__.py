"""Render and train over the device layout (one device so far)."""
