"""solvers/ — steady state (host), shifted and saddle LU/inverse caches,
the Newton-Schulz inverse-stack build, Krylov solvers with the
reference-LU caches, and the matrix-free saddle cache."""
