"""newton_krylov_ooc_tpu_torch.utils"""
