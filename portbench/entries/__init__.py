"""Drivers of the traffic entries, one module each, found by name."""
