"""ops/ — ELL sparse operator, low-rank algebra, the convection kernel."""
