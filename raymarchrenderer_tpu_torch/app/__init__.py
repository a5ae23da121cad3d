"""Command-line frontend."""
