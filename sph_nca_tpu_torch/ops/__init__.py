"""sph_nca_tpu_torch.ops — SPH kernels, the cell engine and the pair pass."""
