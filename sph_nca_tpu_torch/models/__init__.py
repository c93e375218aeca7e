"""sph_nca_tpu_torch.models — the NCA model and the cell-engine rollout."""
