"""solvers/ — steady state (host), shifted-saddle solves and the
Newton-Schulz inverse-stack build."""
