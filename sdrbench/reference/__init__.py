"""The plain reference of the benchmark (chain.py)."""
