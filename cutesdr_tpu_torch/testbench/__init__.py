"""Probe instruments of the port."""
