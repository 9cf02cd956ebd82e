"""The receiver chain of the port."""
