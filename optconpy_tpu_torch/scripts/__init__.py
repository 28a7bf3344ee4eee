"""scripts/ — the reference's measurement scripts as port modules.

Counterparts of the JAX package's scripts/ under the same file names:
validate_gains (the bench-shape gain certification), config3_cylinder
(config 3, refinement 2) and config3xl_cylinder (refinement 3). Each
module has run(device, ...), which returns the dict the reference
writes, and main(), which prints it as JSON:

    python -m optconpy_tpu_torch.scripts.config3xl_cylinder [--out FILE]

They run on the card unless --device says otherwise, and write a file
only where --out says.
"""
