"""models/ — problem setups (driven cavity, cylinder wake)."""
