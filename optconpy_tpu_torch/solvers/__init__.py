"""solvers/ — steady state (host), shifted and saddle LU/inverse caches
and the Newton-Schulz inverse-stack build."""
