"""Loaders of the port: the index state machine and the device-resident
full-batch loader."""
