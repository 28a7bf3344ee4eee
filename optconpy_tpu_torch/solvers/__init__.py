"""solvers/ — steady state (host) and shifted-saddle solves."""
