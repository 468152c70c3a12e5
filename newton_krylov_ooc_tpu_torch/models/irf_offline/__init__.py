"""newton_krylov_ooc_tpu_torch.models.irf_offline"""
