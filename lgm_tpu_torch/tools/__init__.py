"""Command-line tools of the port (weights converters)."""
