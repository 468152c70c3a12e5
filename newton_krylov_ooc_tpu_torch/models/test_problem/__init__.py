"""newton_krylov_ooc_tpu_torch.models.test_problem"""
