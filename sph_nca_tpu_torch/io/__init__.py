"""sph_nca_tpu_torch.io — JSON weight loading and weights carried from JAX."""
