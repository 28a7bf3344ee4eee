"""ops/ — ELL sparse operator, low-rank algebra, the CUDA kernels
(convection, SpMM) and their build."""
