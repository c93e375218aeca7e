"""sph_nca_tpu_torch.utils — grids, seeds, image sampling and targets."""
