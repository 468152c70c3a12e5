"""newton_krylov_ooc_tpu_torch.config"""
