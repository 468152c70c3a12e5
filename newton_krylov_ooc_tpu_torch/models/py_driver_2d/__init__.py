"""newton_krylov_ooc_tpu_torch.models.py_driver_2d"""
