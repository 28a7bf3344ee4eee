"""fem/ — host discretization (numpy/scipy) and its tensor containers."""
