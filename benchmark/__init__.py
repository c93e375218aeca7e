"""The benchmark of sph_nca_tpu_torch: see README.md."""
