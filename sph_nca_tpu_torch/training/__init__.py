"""sph_nca_tpu_torch.training — plane-mode MSE training on the cell engine."""
