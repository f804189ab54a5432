"""Data-parallel training of the port on ``torch.distributed``."""
