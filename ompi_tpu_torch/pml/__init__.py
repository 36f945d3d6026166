"""Point-to-point messaging layer (the reference's ompi/mca/pml)."""
