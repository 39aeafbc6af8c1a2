"""Host utilities of the port (trimmed copies of the reference's)."""
