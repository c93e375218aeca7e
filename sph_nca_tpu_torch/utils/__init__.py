"""sph_nca_tpu_torch.utils — grids and seeds."""
