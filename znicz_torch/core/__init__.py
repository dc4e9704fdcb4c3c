"""Core pieces of the port (its own copy of the config tree)."""
