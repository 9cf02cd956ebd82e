"""Many receiver chains in one step."""
