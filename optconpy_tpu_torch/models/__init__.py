"""models/ — problem setups (cylinder wake)."""
