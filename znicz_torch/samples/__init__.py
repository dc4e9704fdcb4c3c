"""Sample models of the port."""
